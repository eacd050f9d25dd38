"""Hand-written Hopper kernels, their plain versions and the routing.

====================  ==========================  ==========================
module                kernel source               replaces (JAX/Pallas)
====================  ==========================  ==========================
``scaled_matmul``     ``csrc/scaled_matmul.cu``   ``scaled_matmul_pallas``
``acdc_cascade_fused``  ``csrc/acdc_cascade.cu``  ``acdc_cascade_pallas``
``acdc_fused``        ``csrc/acdc_cascade.cu``    ``acdc_fused_pallas``
                      (K=1, no mid matrix)
``paged_attn``        ``csrc/paged_attn.cu``      ``paged_attention``
``acdc_bwd``          ``csrc/acdc_cascade_bwd.cu``  ``acdc_bwd_pallas``
                      (K=1, no mid matrix)
``acdc_cascade_bwd``  ``csrc/acdc_cascade_bwd.cu``  ``acdc_cascade_bwd_pallas``
====================  ==========================  ==========================

``ref`` holds the plain PyTorch version of each, ``build`` compiles the
sources with nvcc and binds them with ctypes, and ``ops`` routes the
ACDC layer and cascade, forward and backward, exactly as the reference
does.  ``csrc/acdc_common.cuh`` holds the thread block cluster machinery
of the two cascade kernels, whose launches ``acdc_cascade_fused.plan``
and ``acdc_cascade_bwd.plan_bwd`` decide; ``paged_attn.plan`` decides
how the paged-attention kernel splits the keys.
"""
