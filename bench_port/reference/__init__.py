"""Plain references the benchmark judges the system against: plain
PyTorch and numpy, importing nothing of the program, working out again
everything the program derives from the weights, bank and inputs the
benchmark hands to both."""
