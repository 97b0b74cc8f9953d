"""Batched volume inference and evaluation with Dice / HD95."""
