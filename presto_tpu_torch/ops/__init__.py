"""Device kernels and the tensor code around them."""
