"""Command entry points of the port (python -m kubernetes_tpu_torch.cmd.X)."""
