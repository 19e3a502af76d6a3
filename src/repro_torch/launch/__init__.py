"""Launchers: the serving and training entry points, device meshes over
``torch.distributed`` and the dry-run's planning half."""
