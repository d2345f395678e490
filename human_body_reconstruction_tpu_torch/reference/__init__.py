"""Plain references of published models, in plain PyTorch, which the
tests and the benchmark hold the program to; each imports nothing of the
program."""
