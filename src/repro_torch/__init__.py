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
device). The transformer LMs' serving path (``models/``, ``configs/``:
the dense and MoE configs, prefill, then decode over a KV cache) runs its
decode attention on a sixth, ``kernels/flash_decode``.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:     # device="cuda"
        print(pipe.evaluate())

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-135m")
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    cache = T.init_cache(cfg, batch=8, max_len=4128)
    logits, cache = T.prefill(cfg, model, prompts, cache)   # (8, 4096) ids
"""
