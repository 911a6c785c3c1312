"""Plain f32 PyTorch references of what the benchmark's cells run.

Written from the published descriptions (ESRGAN, arXiv:1809.00219 and
xinntao/ESRGAN ``RRDBNet_arch.py``; SRGAN, arXiv:1609.04802 §3;
torchvision's VGG19 ``features``), functional, NCHW, on weight
dictionaries keyed as the reference implementations' ``state_dict``s.
Nothing here imports the port, JAX or the JAX package; the weights and
inputs come from the benchmark, which hands the same to the port.

Each conv and dense product takes ``prec`` (``ops.PRECISIONS``): ``f32``
is the reference itself (run it with TF32 off, ``ops.exact_f32``);
``bf16`` and ``fp8`` round the products' operands, the latter being the
control of the cells' correctness checks.
"""
