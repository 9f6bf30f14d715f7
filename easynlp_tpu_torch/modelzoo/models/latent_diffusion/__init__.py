"""Latent diffusion for the PyTorch port. Only the parameter EMA is ported
so far (the Trainer's --ema_decay); the models are ROADMAP A22."""
