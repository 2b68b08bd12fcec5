"""Plain NumPy references of what the cells' engines compute.  They import
nothing of the program, nor JAX."""
