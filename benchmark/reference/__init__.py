"""The plain reference: float32 PyTorch and NumPy only, importing nothing of
the program under test; it takes the weights and images the benchmark made
and works out the tiling, the padding, the rounding and the alpha bicubic
itself."""
