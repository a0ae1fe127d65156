"""The masked FedAvg trainer, approaches and history."""
