"""Attention functions and the hand-written kernels behind them."""
