"""Plain PyTorch / NumPy references, in float32 (float64 on the host).
They import nothing of the program."""
