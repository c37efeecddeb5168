"""The plain reference that decides `correct`: plain PyTorch on the
harness's own COO, no kernel, no import of the program or of JAX."""
