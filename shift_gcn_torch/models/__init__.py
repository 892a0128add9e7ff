"""Shift-GCN model as a torch module with reference state_dict names."""
