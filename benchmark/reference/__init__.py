"""The plain PyTorch reference that decides `correct`; imports nothing of
the program."""
