"""Device operators of the port: far field, near field, noise, Lanczos."""
