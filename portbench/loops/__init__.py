"""The loops of the traffic kinds (``loops/<kind>.py``): each runs a
cell's set-up, window and comparison and returns what ``run.py``
prints."""
