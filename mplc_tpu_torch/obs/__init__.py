"""Observability: the value ledger and its drift diff."""
