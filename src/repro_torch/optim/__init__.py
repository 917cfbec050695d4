"""Optimizers and the group-lasso regularizer."""
