"""solver layer of the PyTorch port."""
