"""Plain references, in PyTorch alone: they import neither JAX, the JAX
package nor anything of ``repro_torch``, and read only what the harness
generated (the COO and the factors), never what the program built."""
