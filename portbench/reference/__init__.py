"""Plain float32 references, one per model family
(``reference/<family>.py``).  They import neither JAX, nor the JAX
package, nor anything of the program."""
