"""The carver engine on PyTorch: state, energy, plain DP, engine."""
