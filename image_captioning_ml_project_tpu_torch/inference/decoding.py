"""Batched beam search with KV cache, in PyTorch.

Counterpart of ``beam_search`` in ``image_captioning_ml_project_tpu.
inference.decoding``, over the same uniform decoder interface::

    step_fn(state, tokens[N]) -> (logits[N, V], state)

``state`` is a dict whose tensors carry a leading batch axis, with the JAX
package's special subtrees: ``shared`` (per-image constants, never tiled),
``lazy`` (caches tiled once and never permuted; the engine reorders only
their ``ancestry`` map) and ``static``. Scores follow HF: ``sum_logprobs /
length ** length_penalty``, with EOS suppressed while ``len < min_length``.

The JAX version is one ``lax.while_loop``; here the loop runs on the host
and checks once per step whether every batch has stopped.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops.lse import lse_and_block_max
from ..ops.topk import fused_beam_top_k, top_k

_NEG_INF = -1.0e9


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every tensor with a batch axis in a dict/list tree;
    scalars (0-dim tensors, Python numbers) pass through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return fn(tree)
    return tree


def _tile_state(state: dict, factor: int) -> dict:
    """Repeat each batch row ``factor`` times (B -> B*factor); ``shared``
    is kept as it is. The ``lazy`` caches are tiled here, once; the
    layer-stacked ``lazy["stacked"]`` caches ``[L, B, ...]`` on axis 1."""
    def tile(dim):
        return lambda x: x.repeat_interleave(factor, dim=dim)

    out = {}
    for k, v in state.items():
        if k == "shared":
            out[k] = v
        elif k == "lazy" and "stacked" in v:
            out[k] = dict(_map(tile(0), {n: t for n, t in v.items()
                                         if n != "stacked"}),
                          stacked=_map(tile(1), v["stacked"]))
        else:
            out[k] = _map(tile(0), v)
    return out


def _gather_state(state: dict, flat_indices: torch.Tensor) -> dict:
    """Gather batch rows by ``flat_indices``, except ``shared`` and
    ``static``; of ``lazy`` only the ``ancestry`` map is gathered."""
    out = {}
    for k, v in state.items():
        if k in ("shared", "static"):
            out[k] = v
        elif k == "lazy":
            out[k] = dict(v, ancestry=v["ancestry"][flat_indices])
        else:
            out[k] = _map(lambda x: x[flat_indices], v)
    return out


def _device(tree: Any) -> torch.device:
    if isinstance(tree, torch.Tensor):
        return tree.device
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        dev = _device(child)
        if dev is not None:
            return dev
    return None


def _length_norm(t: int, length_penalty: float) -> float:
    """``t ** length_penalty`` evaluated in float32, as the JAX engine
    evaluates it on its traced int32 step counter."""
    return float(torch.tensor(float(t)) ** length_penalty)


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, L] best hypothesis (or [B, K, L] if return_all)
    scores: torch.Tensor  # [B] (or [B, K]) length-normalized log prob


def beam_search(step_fn, init_state, batch_size: int, beam_size: int,
                bos_token_id: int, eos_token_id: int, pad_token_id: int,
                max_length: int, length_penalty: float = 1.0,
                min_length: int = 0, return_all: bool = False,
                hf_compat: bool = True) -> BeamResult:
    """Batched beam search with KV cache, token-identical to the JAX
    package's ``beam_search`` with one beam group (diverse groups are not
    yet ported: ROADMAP.md Queue 1, greedy, sampling and diverse
    decodes).

    ``init_state`` is the untiled ``[B, ...]`` decode state; it is tiled to
    ``B * K`` rows here. ``hf_compat=True`` keeps HF ``generate``'s
    finishing rules: a hypothesis may finish only if its EOS candidate
    ranks within the top ``K`` of the step's ``2K`` candidates, and a batch
    stops (its finished set frozen, its live beams excluded) once all K
    finished slots are filled and the best running beam, normalised at its
    current length, cannot beat the worst finished score; the loop ends
    when every batch has stopped. ``hf_compat=False`` lets any of the 2K
    candidates finish and always runs to ``max_length``.

    For LM-sized vocabularies (V > 4096) the candidate step reads the raw
    logits once through :func:`..ops.lse.lse_and_block_max` (the CUDA
    kernel on a CUDA tensor) and :func:`..ops.topk.fused_beam_top_k`,
    never materialising a vocab-sized log-softmax.
    """
    B, K = batch_size, beam_size
    L = max_length
    dev = _device(init_state)

    state = _tile_state(init_state, K)
    if "lazy" in state:
        # lazy beam reorder: the caches are never permuted; the ancestry
        # map names, per slot and position, the row holding that K/V
        anc = torch.arange(B * K, dtype=torch.int32, device=dev)
        state["lazy"] = dict(state["lazy"],
                             ancestry=anc[:, None].repeat(1, L))
    rows_b = torch.arange(B, device=dev)[:, None]
    own_rows = torch.arange(B * K, dtype=torch.int32, device=dev)

    sequences = torch.full((B, K, L), pad_token_id, dtype=torch.long,
                           device=dev)
    sequences[:, :, 0] = bos_token_id
    live_scores = torch.full((B, K), _NEG_INF, device=dev)
    live_scores[:, 0] = 0.0
    fin_seqs = torch.full((B, K, L), pad_token_id, dtype=torch.long,
                          device=dev)
    fin_scores = torch.full((B, K), _NEG_INF, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    rank_ok = torch.arange(2 * K, device=dev)[None, :] < K

    for t in range(1, L):
        if "lazy" in state:
            # position t-1 is written this step by each slot itself
            state["lazy"]["ancestry"][:, t - 1] = own_rows
        current = sequences[:, :, t - 1].reshape(B * K)
        logits, state = step_fn(state, current)
        V = logits.shape[-1]
        if V > 4096:
            lse, bmax = lse_and_block_max(logits)
            row_bias = live_scores.reshape(B * K) - lse
            cand_scores, cand_idx = fused_beam_top_k(
                logits, row_bias, K, 2 * K, suppress_token=eos_token_id,
                suppress=t < min_length, block_max=bmax)
        else:
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            if t < min_length:
                logp[:, :, eos_token_id] = _NEG_INF
            total = live_scores[:, :, None] + logp
            cand_scores, cand_idx = top_k(total.reshape(B, K * V), 2 * K)
        cand_beam = cand_idx // V
        cand_tok = cand_idx % V
        is_eos = cand_tok == eos_token_id

        # finished candidates: length-normalised score
        norm = cand_scores / _length_norm(t, length_penalty)
        fin_cand = norm.masked_fill(~is_eos, _NEG_INF)
        if hf_compat:
            fin_cand = fin_cand.masked_fill(~rank_ok | stopped[:, None],
                                            _NEG_INF)
        cand_seqs = sequences.gather(
            1, cand_beam[:, :, None].expand(B, 2 * K, L)).clone()
        cand_seqs[:, :, t] = cand_tok
        top_fin_scores, top_fin_idx = top_k(
            torch.cat([fin_scores, fin_cand], dim=1), K)
        fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1).gather(
            1, top_fin_idx[:, :, None].expand(B, K, L))
        fin_scores = top_fin_scores

        # live continuation: best K non-EOS candidates
        live_scores, top_live_idx = top_k(
            cand_scores.masked_fill(is_eos, _NEG_INF), K)
        sel_beam = cand_beam.gather(1, top_live_idx)
        sequences = sequences.gather(
            1, sel_beam[:, :, None].expand(B, K, L)).clone()
        sequences[:, :, t] = cand_tok.gather(1, top_live_idx)
        state = _gather_state(state, (rows_b * K + sel_beam).reshape(B * K))

        if hf_compat:
            all_finished = (fin_scores > _NEG_INF / 2).all(dim=1)
            best_running = (live_scores.max(dim=1).values
                            / _length_norm(t, length_penalty))
            stopped = stopped | (all_finished & (
                best_running <= fin_scores.min(dim=1).values))
            if bool(stopped.all()):
                break

    # merge unfinished live beams (normalised at full length) with finished
    live_norm = live_scores / (float(L - 1) ** length_penalty)
    if hf_compat:
        live_norm = live_norm.masked_fill(stopped[:, None], _NEG_INF)
    top_scores, top_idx = top_k(torch.cat([fin_scores, live_norm], dim=1), K)
    top_seqs = torch.cat([fin_seqs, sequences], dim=1).gather(
        1, top_idx[:, :, None].expand(B, K, L))
    if return_all:
        return BeamResult(top_seqs, top_scores)
    return BeamResult(top_seqs[:, 0], top_scores[:, 0])
