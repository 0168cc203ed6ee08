from drivescenegen_torch.models.unet2d import UNet2D  # noqa: F401
