"""The benchmark's plain reference: frozen plain-PyTorch copies of the port's
twins (each file names the port file and the commit it was copied from), run
in the program's place to decide whether a run's outputs are correct. It
imports nothing of `gsjax_torch`, `gsjax` or JAX."""
