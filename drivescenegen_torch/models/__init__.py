from drivescenegen_torch.models.unet2d import DropoutMasks, UNet2D  # noqa: F401
