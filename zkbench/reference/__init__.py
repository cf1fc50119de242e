"""The plain reference: PyTorch and Python ints only, nothing of the program under test."""
