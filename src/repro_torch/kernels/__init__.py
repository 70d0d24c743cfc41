"""The hand-written kernels: CUDA C++ for Hopper under ``csrc/``, their
Python wrappers, the plain torch contracts (``ref``) and the public entry
points with implementation dispatch (``ops``)."""
