"""PyTorch port of the PolySketchFormer reproduction, for NVIDIA Hopper.

Laid out like the JAX package ``repro`` (the reference, which this package
never imports): ``configs``, ``core``, ``kernels``, ``models``, ``serve``,
``launch``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
