"""Plain PyTorch references of the models the port serves: float32, no
kernels, no cache, nothing of either package. The tests hold the port to
them."""
