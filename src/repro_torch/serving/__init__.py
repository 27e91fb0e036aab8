"""repro_torch.serving — tracing for the port's read path."""
