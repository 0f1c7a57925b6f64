"""Device operations of the port: the kernels' wrappers and the grower."""
