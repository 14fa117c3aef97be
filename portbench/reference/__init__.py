"""Plain references in PyTorch, independent of the program: the comparisons that decide `correct` read them."""
