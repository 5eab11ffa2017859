"""Numerical building blocks of the port: quadrature, Legendre tables,
the eigen stage and the BVP solve with their CUDA kernels."""
