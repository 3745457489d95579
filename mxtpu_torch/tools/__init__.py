"""Command-line tools of the PyTorch port: ``python -m
mxtpu_torch.tools.launch`` starts a distributed-store job."""
