"""Model families, layers and the optimizer."""
