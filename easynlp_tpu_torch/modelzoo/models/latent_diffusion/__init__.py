"""Latent diffusion for the PyTorch port: the UNet (`unet.py`), the KL VAE
(`autoencoder.py`), the schedule and samplers (`ddim.py`), OLSS
(`olss.py`), ControlNet (`controlnet.py`), ESRGAN (`esrgan.py`), the
checkpoint names (`conversion.py`) and the parameter EMA the Trainer's
--ema_decay keeps (`ema.py`)."""
