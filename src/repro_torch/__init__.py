"""PyTorch/CUDA port of the ESPN retrieval stack.

A second package beside ``repro`` (the JAX reference). It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro`` — and keeps its own
copy of every module it needs. The query path runs the ``espn`` backend
(two-phase IVF candidate generation, ANN-guided prefetch over the storage
tier, MaxSim rerank), the non-prefetching ``gds``/``mmap``/``swap``/``dram``
backends, the ``bitvec``/``fde``/``cascade`` backends over resident
sign-bit and FDE tables, and ``cspn`` over the constant-space
``fixed_stride`` layout of a pooled corpus, on five hand-written CUDA
kernels: ``kernels/maxsim``, ``kernels/ivf_scan``, ``kernels/bitsim``,
``kernels/fdescan`` and ``kernels/gather_pack`` (the restructuring step
that packs every rerank's tiles from the raw rows a read moved to the
device).

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:     # device="cuda"
        print(pipe.evaluate())
"""
