"""Plain f32 references the benchmark holds the port to. They import
nothing of the port, of the JAX package or of JAX; they read only the
inputs and weights the benchmark made, and the program's outputs only to
judge them."""
