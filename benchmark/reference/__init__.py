"""The plain reference: exact k-NN with the contract's tie rules, written
in plain PyTorch, importing nothing of the program."""
