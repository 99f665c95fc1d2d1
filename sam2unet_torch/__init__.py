"""SAM2-UNet in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

The package mirrors the layout of `sam2unet_tpu/` so each module has a
counterpart there; it imports neither JAX nor that package. Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
