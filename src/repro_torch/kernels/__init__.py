"""Hand-written Hopper kernels, their plain versions and the routing.

====================  ==========================  ==========================
module                kernel source               replaces (JAX/Pallas)
====================  ==========================  ==========================
``scaled_matmul``     ``csrc/scaled_matmul.cu``   ``scaled_matmul_pallas``
``acdc_cascade_fused``  ``csrc/acdc_cascade.cu``  ``acdc_cascade_pallas``
``acdc_fused``        ``csrc/acdc_cascade.cu``    ``acdc_fused_pallas``
                      (K=1, no mid matrix)
``paged_attn``        ``csrc/paged_attn.cu``      ``paged_attention``
====================  ==========================  ==========================

``ref`` holds the plain PyTorch version of each, ``build`` compiles the
sources with nvcc and binds them with ctypes, and ``ops`` routes the
ACDC layer and cascade exactly as the reference does.  The two backward
kernels (``acdc_bwd``, ``acdc_cascade_bwd``) are not ported yet.
"""
