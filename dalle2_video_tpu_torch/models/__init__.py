from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

__all__ = ["UNet3D", "UNet3DConfig"]
