"""Device kernels (SURVEY.md L2 hot loops): the segment decoder called through jax.ffi, the plain XLA lane decoder, the int8-matmul CRC."""
