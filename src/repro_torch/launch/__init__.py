"""Entry points of the port's model zoo (``serve``, ``train``)."""
