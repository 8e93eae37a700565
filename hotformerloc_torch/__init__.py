"""HOTFormerLoc in PyTorch with hand-written CUDA kernels for Hopper.

The serving path: lidar points -> on-device octree -> HOTFormerLoc
backbone -> 256-d descriptors -> top-k retrieval. The JAX package
``hotformerloc_tpu`` beside it is the reference this package is held
against; nothing here imports it.
"""
