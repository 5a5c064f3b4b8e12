"""Frozen work counts and the card's peaks, independent of the program."""
