"""Applications: the distributed Jacobi stencil."""
