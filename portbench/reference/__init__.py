"""Plain float32 PyTorch references that the benchmark judges the port
against.  Nothing here imports the program under test."""
