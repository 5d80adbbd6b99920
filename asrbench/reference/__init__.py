"""The plain reference: float64 / float32 PyTorch written from the
published descriptions, importing nothing of the program."""
