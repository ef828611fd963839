"""The benchmark of the PyTorch port (``mrisr_torch``): ``python3 -m perfbench.run``; see ``README.md``."""
