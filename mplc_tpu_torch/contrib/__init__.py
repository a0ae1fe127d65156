"""Contributivity: staging, reconstruction and the estimators."""
