"""Carry the reference package's state across into the port.

Every function takes plain numpy arrays — the fields the reference's
``IVFIndex``, ``EmbeddingLayout``, ``BitTable`` and ``FDETable`` hold, under
the names its ``.npz`` artifacts use — so a mapping from ``np.load`` of a
saved ``index.npz`` / ``layout.npz`` / ``bits.npz`` / ``fde.npz`` works as
well as a dict built in memory; and the nested parameter dicts of the
transformer, the ColBERTer encoder, the RecSys models and GatedGCN. The way back gives the reference's nested
dicts of a model's parameters and of an optimizer state, so that both
packages start from, and can compare, the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fde import FDEConfig, FDETable
from repro_torch.configs.base import (ColberterConfig, GNNConfig,
                                      RecsysConfig, TransformerConfig)
from repro_torch.core.ivf import IVFIndex
from repro_torch.device import resolve_device
from repro_torch.models import colberter, gnn, recsys
from repro_torch.models.transformer import TransformerLM, param_table
from repro_torch.storage.layout import BitTable, EmbeddingLayout
from repro_torch.train.checkpoint import flatten, to_host, unflatten
from repro_torch.train.optimizer import named_params


def _optional(a) -> np.ndarray | None:
    """``None`` and empty arrays both mean "absent" (npz stores an empty
    placeholder for a missing optional array)."""
    if a is None:
        return None
    a = np.asarray(a)
    return a if a.size else None


def ivf_index_from_numpy(arrays, device) -> IVFIndex:
    """IVF index from ``centroids``, ``cell_ids``, ``cell_vecs``,
    ``cell_scale``, ``cell_sizes``, ``n_docs`` and ``quant``, with its
    tensors copied to ``device``."""
    scale = _optional(arrays["cell_scale"])
    return IVFIndex(
        centroids=torch.tensor(np.asarray(arrays["centroids"], np.float32),
                               device=device),
        cell_ids=torch.tensor(np.asarray(arrays["cell_ids"], np.int32),
                              device=device),
        cell_vecs=torch.tensor(np.asarray(arrays["cell_vecs"]),
                               device=device),
        cell_scale=(torch.tensor(scale.astype(np.float32), device=device)
                    if scale is not None else None),
        cell_sizes=np.asarray(arrays["cell_sizes"]),
        n_docs=int(arrays["n_docs"]), quant=str(arrays["quant"]))


def layout_from_numpy(arrays) -> EmbeddingLayout:
    """Embedding layout from ``blob``, ``d_cls``, ``d_bow``, ``dtype``,
    ``scales``, ``block`` and, for a ragged layout, ``offsets`` and
    ``n_tokens``. A ``mode`` of ``fixed_stride`` (with ``stride_blocks`` and
    ``pool_k``) carries the constant-space layout across: its offsets and
    token counts are recomputed from the stride, as the reference does on
    load, whatever the mapping holds under those names. The layout stays a
    host blob, as the storage tier reads it."""
    mode = str(arrays["mode"]) if "mode" in arrays else "ragged"
    fixed = mode == "fixed_stride"
    return EmbeddingLayout(
        blob=np.asarray(arrays["blob"], np.uint8),
        offsets=None if fixed else np.asarray(arrays["offsets"], np.int64),
        n_tokens=None if fixed else np.asarray(arrays["n_tokens"], np.int32),
        d_cls=int(arrays["d_cls"]), d_bow=int(arrays["d_bow"]),
        dtype=np.dtype(str(arrays["dtype"])),
        scales=_optional(arrays["scales"]),
        block=int(arrays["block"]), mode=mode,
        stride_blocks=int(arrays["stride_blocks"]) if fixed else 0,
        pool_k=int(arrays["pool_k"]) if fixed else 0)


def bit_table_from_numpy(arrays) -> BitTable:
    """Resident sign-bit table from ``packed``, ``starts`` and ``d_bow``
    (host arrays, as the storage tier gathers them)."""
    return BitTable(packed=np.asarray(arrays["packed"]),
                    starts=np.asarray(arrays["starts"], np.int64),
                    d_bow=int(arrays["d_bow"]))


def fde_table_from_numpy(arrays, device) -> FDETable:
    """Resident FDE table from ``vecs``, ``d_bow``, ``k_sim``, ``r_reps``,
    ``d_final``, ``fill_empty`` and ``seed``, with ``vecs`` copied to
    ``device`` in its stored dtype."""
    cfg = FDEConfig(d_bow=int(arrays["d_bow"]), k_sim=int(arrays["k_sim"]),
                    r_reps=int(arrays["r_reps"]),
                    d_final=int(arrays["d_final"]),
                    fill_empty=bool(arrays["fill_empty"]),
                    seed=int(arrays["seed"]))
    return FDETable(vecs=torch.tensor(np.asarray(arrays["vecs"]),
                                      device=device), cfg=cfg)


def transformer_params_from_numpy(params, cfg: TransformerConfig,
                                  device) -> TransformerLM:
    """The LM with the weights of the reference's nested parameter dict
    (``embed``, ``final_norm``, [``lm_head``,] ``layers/{wq, ...}``, with an
    MoE model's ``layers/{router, w_gate, ...}`` and shared-expert
    ``layers/{w_gate_s, ...}``; numpy arrays of the reference's shapes), on
    ``device`` in ``cfg.param_dtype``. A missing, extra or misshapen array
    raises."""
    return _fill(TransformerLM(cfg, device), param_table(cfg), params,
                 cfg.name)


def colberter_params_from_numpy(params, cfg: ColberterConfig,
                                device) -> colberter.Colberter:
    """The ColBERTer encoder with the weights of the reference's nested
    parameter dict (``embed``, ``pos_embed``, ``embed_norm/{scale,bias}``,
    ``layers/{wq, ..., ln1/scale, ...}``, ``cls_head``, ``bow_head``,
    ``score_scale``; numpy arrays of the reference's shapes), on ``device``
    in ``cfg.param_dtype``. A missing, extra or misshapen array raises."""
    return _fill(colberter.Colberter(cfg, device), colberter.param_table(cfg),
                 params, cfg.name)


def recsys_params_from_numpy(params, cfg: RecsysConfig, device) -> dict:
    """The RecSys model's nested parameter dict (``tables/table_{i}`` with
    their stored pad rows, ``linear``, ``bias``, ``bot``, ``top``,
    ``attn_{l}``, ``out``, ``q_tower``, ``i_tower``: whichever
    ``recsys.param_shapes(cfg)`` names) from the reference's, on ``device``
    in ``cfg.param_dtype``. A missing, extra or misshapen array raises."""
    return _tensors(recsys.param_shapes(cfg), params, device, cfg.name)


def gnn_params_from_numpy(params, cfg: GNNConfig, d_in: int,
                          device) -> dict:
    """GatedGCN's nested parameter dict (``embed_h/{w,b}``,
    ``embed_e_src``, ``embed_e_dst``, ``layers/{A, ..., e_bias}`` stacked
    over the layers, ``out/{w,b}``) from the reference's, on ``device`` in
    ``cfg.param_dtype``. A missing, extra or misshapen array raises."""
    return _tensors(gnn.param_shapes(cfg, d_in), params, device, cfg.name)


def _tensors(shapes: dict, params, device, what: str) -> dict:
    """``params`` (nested numpy) as a nested dict of tensors of the names,
    shapes and dtypes of ``shapes`` (nested ``meta`` tensors)."""
    dev = resolve_device(device)
    want = flatten(shapes)
    arrays = _checked({k: tuple(t.shape) for k, t in want.items()}, params,
                      what)
    return unflatten({k: torch.tensor(a, dtype=want[k].dtype, device=dev)
                      for k, a in arrays.items()})


def _fill(model, table: dict, params, what: str):
    """Copy the nested dict ``params`` into ``model``'s parameters, whose
    names and shapes ``table`` lists ("/"-joined)."""
    arrays = _checked({k: tuple(s) for k, (s, _) in table.items()}, params,
                      what)
    with torch.no_grad():
        for name, a in arrays.items():
            model.get_parameter(name.replace("/", ".")).copy_(
                torch.tensor(a))
    return model


def _checked(shapes: dict[str, tuple], params, what: str) -> dict:
    """``params`` flattened to numpy arrays, which must carry exactly the
    names of ``shapes`` ("/"-joined), each of its shape."""
    flat = flatten(params)
    if set(flat) != set(shapes):
        raise ValueError(f"parameter names differ from {what}'s: missing "
                         f"{sorted(set(shapes) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(shapes))}")
    out = {}
    for name, shape in shapes.items():
        a = np.asarray(flat[name])
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        out[name] = a
    return out


def params_to_numpy(params) -> dict:
    """The reference's nested parameter dict (host numpy copies) of a model
    (``Colberter``, ``TransformerLM``) or a dict of tensors."""
    return unflatten({k: to_host(v) for k, v in named_params(params).items()})


def opt_state_to_numpy(state: dict) -> dict:
    """The reference's optimizer state (``m``, ``v``: nested dicts like the
    parameters', fp32; ``step``: int32 scalar) from the port's."""
    return {k: to_host(v) if k == "step" else
            unflatten({n: to_host(t) for n, t in v.items()})
            for k, v in state.items()}


def opt_state_from_numpy(tree: dict, device) -> dict:
    """The port's optimizer state on ``device`` from the reference's (or a
    restored checkpoint's): flat dicts of fp32 tensors under "/"-joined
    names, and ``step`` as an int32 scalar tensor."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.int32, device=dev)
            if k == "step" else
            {n: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
             for n, a in flatten(v).items()}
            for k, v in tree.items()}
