"""Batched decoding in PyTorch: greedy, temperature/nucleus sampling and
(diverse) beam search with KV cache.

Counterpart of ``image_captioning_ml_project_tpu.inference.decoding``, over
the same uniform decoder interface::

    step_fn(state, tokens[N]) -> (logits[N, V], state)

``state`` is a dict whose tensors carry a leading batch axis, with the JAX
package's special subtrees: ``shared`` (per-image constants, never tiled),
``lazy`` (caches tiled once and never permuted; the engine reorders only
their ``ancestry`` map) and ``static``. Beam scores follow HF:
``sum_logprobs / length ** length_penalty``, with EOS suppressed while
``len < min_length``.

The JAX versions are ``lax.while_loop``s and ``lax.scan``s; here the loops
run on the host, and the early-exit ones check once per step whether
every row (or batch) is done. Sampling takes a ``torch.Generator`` where
the JAX package takes an ``rng`` key; its Gumbel noise comes from
:func:`gumbel_noise`.

Each step is a span ``decode.step`` and each check a span
``decode.stop_check`` with a count of ``decode.host_syncs``
(:mod:`..utils.profiling`); ``decode_images``'s ``init_cache`` is
``decode.encode``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops.lse import lse_and_block_max
from ..ops.topk import fused_beam_top_k, top_k
from ..utils.profiling import count, span

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


def _all_done(flags: torch.Tensor) -> bool:
    """Whether every flag is set: the device-to-host read that ends an
    early-exit loop, once a step (span ``decode.stop_check``, counter
    ``decode.host_syncs``)."""
    with span("decode.stop_check"):
        count("decode.host_syncs")
        return bool(flags.all())


def _suppress_eos(logits: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """``logits`` with the EOS column set to -1e9 (a copy)."""
    logits = logits.clone()
    logits[..., eos_token_id] = _NEG_INF
    return logits


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------


def greedy_decode(step_fn, init_state, batch_size: int, bos_token_id: int,
                  max_length: int, eos_token_id: Optional[int] = None,
                  pad_token_id: Optional[int] = None, min_length: int = 0,
                  early_exit: bool = True) -> torch.Tensor:
    """Greedy argmax decode: tokens ``[B, max_length]`` (int64), BOS at
    position 0.

    With ``eos_token_id`` every position after a row's first EOS is
    ``pad_token_id`` (EOS when None), and ``min_length`` suppresses EOS
    while the step counter ``t`` (1 at the first step) is below it. With
    ``early_exit`` (and an EOS) the loop ends once every row is done, after
    at most ``max_length - 1`` steps; otherwise it runs ``max_length`` steps
    and keeps each step's input token, as the JAX package's scan does.
    ``torch.argmax`` takes the first of equal maxima, as ``jnp.argmax``
    does."""
    dev = _device(init_state)
    B = batch_size
    if eos_token_id is not None and pad_token_id is None:
        pad_token_id = eos_token_id
    current = torch.full((B,), bos_token_id, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    state = init_state

    def next_token(state, current, done, t):
        logits, state = step_fn(state, current)
        if eos_token_id is not None and min_length > 0 and t < min_length:
            logits = _suppress_eos(logits, eos_token_id)
        nxt = torch.argmax(logits, dim=-1)
        if eos_token_id is not None:
            nxt = nxt.masked_fill(done, pad_token_id)
            done = done | (nxt == eos_token_id)
        return state, nxt, done

    if eos_token_id is not None and early_exit:
        out = torch.full((B, max_length), pad_token_id, dtype=torch.long,
                         device=dev)
        out[:, 0] = bos_token_id
        for t in range(1, max_length):
            with span("decode.step"):
                state, current, done = next_token(state, current, done, t)
                out[:, t] = current
                if _all_done(done):
                    break
        return out

    tokens = []
    for t in range(1, max_length + 1):
        with span("decode.step"):
            tokens.append(current)
            state, current, done = next_token(state, current, done, t)
    return torch.stack(tokens, dim=1)


# ---------------------------------------------------------------------------
# Sampling (temperature / nucleus)
# ---------------------------------------------------------------------------


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` in float32, ``u`` uniform on
    ``[finfo.tiny, 1)``, drawn from ``generator`` on ``device``: the noise
    of JAX's ``categorical`` draw, ``argmax(logits + gumbel(key))``.
    :func:`sample_decode` draws each step's noise through this name, so a
    caller can stand other noise in for it."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution with cumulative probability >= ``top_p`` (the tokens whose
    preceding cumulative mass is below it: always at least one); the rest
    become -1e9. The threshold is the smallest kept logit, and every logit
    at or above it is kept."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full((), float("inf"),
                                       device=logits.device)).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits,
                       torch.full((), _NEG_INF, dtype=logits.dtype,
                                  device=logits.device))


class SampleResult(NamedTuple):
    tokens: torch.Tensor    # [B, L] (position 0 = BOS), int64
    logprobs: torch.Tensor  # [B, L] f32 log p(token_t); 0 where inactive
    mask: torch.Tensor      # [B, L] True for sampled (pre/at-EOS) positions


def sample_decode(step_fn, init_state, generator: torch.Generator,
                  batch_size: int, bos_token_id: int, eos_token_id: int,
                  pad_token_id: int, max_length: int,
                  temperature: float = 1.0, top_p: float = 1.0,
                  min_length: int = 0,
                  early_exit: bool = True) -> SampleResult:
    """Ancestral sampling with temperature and optional nucleus filtering.

    Per step: f32 logits divided by ``temperature``, EOS suppressed while
    ``t < min_length``, the top-p filter when ``top_p < 1``, then
    ``log_softmax``; the draw is ``argmax(logits + gumbel_noise(...))``
    (step ``t`` draws the noise the JAX package draws from
    ``rngs[t - 1]``). After EOS a row emits pads with logprob 0 and mask
    False. ``early_exit`` ends the loop once every row has sampled EOS
    (after at most ``max_length - 1`` steps); otherwise it runs
    ``max_length`` steps and keeps each step's input, as the JAX scan
    does."""
    dev = _device(init_state)
    B = batch_size
    current = torch.full((B,), bos_token_id, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)
    state = init_state

    def sample(state, current, done, t):
        logits, state = step_fn(state, current)
        logits = logits.float() / temperature
        if t < min_length:
            logits = _suppress_eos(logits, eos_token_id)
        if top_p < 1.0:
            logits = _top_p_filter(logits, top_p)
        logp = torch.log_softmax(logits, dim=-1)
        noise = gumbel_noise(logits.shape, generator, logits.device)
        sampled = torch.argmax(logits + noise, dim=-1)
        tok_logp = logp.gather(1, sampled[:, None])[:, 0]
        nxt = sampled.masked_fill(done, pad_token_id)
        tok_logp = torch.where(done, zero, tok_logp)
        active = ~done
        done = done | (sampled == eos_token_id)
        return state, nxt, tok_logp, active, done

    if early_exit:
        tokens = torch.full((B, max_length), pad_token_id, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = bos_token_id
        logprobs = torch.zeros((B, max_length), device=dev)
        mask = torch.zeros((B, max_length), dtype=torch.bool, device=dev)
        for t in range(1, max_length):
            with span("decode.step"):
                state, nxt, tok_logp, active, done = sample(
                    state, tokens[:, t - 1], done, t)
                tokens[:, t] = nxt
                logprobs[:, t] = tok_logp
                mask[:, t] = active
                if _all_done(done):
                    break
        return SampleResult(tokens, logprobs, mask)

    cur_logp = torch.zeros(B, device=dev)           # BOS is given
    cur_active = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for t in range(1, max_length + 1):
        with span("decode.step"):
            out.append((current, cur_logp, cur_active))
            state, current, cur_logp, cur_active, done = sample(
                state, current, done, t)
    return SampleResult(*(torch.stack(col, dim=1) for col in zip(*out)))


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, L] best hypothesis (or [B, K, L] if return_all)
    scores: torch.Tensor  # [B] (or [B, K]) length-normalized log prob


def beam_search(step_fn, init_state, batch_size: int, beam_size: int,
                bos_token_id: int, eos_token_id: int, pad_token_id: int,
                max_length: int, length_penalty: float = 1.0,
                min_length: int = 0, num_beam_groups: int = 1,
                diversity_penalty: float = 0.0, return_all: bool = False,
                hf_compat: bool = True) -> BeamResult:
    """Batched (diverse) beam search with KV cache, token-identical to the
    JAX package's ``beam_search``.

    ``init_state`` is the untiled ``[B, ...]`` decode state; it is tiled to
    ``B * K`` rows here. With ``num_beam_groups`` G > 1 the K beams split
    into G groups of ``K / G`` that select their candidates in turn
    (Hamming diversity): group g's token log-probabilities are lowered by
    ``diversity_penalty`` times the number of times the groups before it
    chose each token at this step. One model call per step serves every
    group.

    ``hf_compat=True`` keeps HF ``generate``'s finishing rules, per group:
    a hypothesis may finish only if its EOS candidate ranks within the top
    ``K / G`` of the group's ``2K / G`` candidates, and a group stops (its
    finished set frozen, its live beams excluded) once all its finished
    slots are filled and its best running beam, normalised at its current
    length, cannot beat its worst finished score; the loop ends when every
    group of every batch has stopped. ``hf_compat=False`` lets any
    candidate finish and always runs to ``max_length``.

    For LM-sized vocabularies (V > 4096) the candidate step reads the raw
    logits through :func:`..ops.lse.lse_and_block_max` (the CUDA kernel on
    a CUDA tensor) and :func:`..ops.topk.fused_beam_top_k`, never
    materialising a vocab-sized log-softmax. With several groups the
    kernel's block maxima are dropped (the penalty changes them) and each
    group's candidates come from its own penalised rows.
    """
    B, K, G = batch_size, beam_size, num_beam_groups
    if G < 1 or K % G:
        raise ValueError(f"beam_size {K} is not divisible by "
                         f"num_beam_groups {G}")
    Kg = K // G
    L = max_length
    dev = _device(init_state)
    penalise = G > 1 and diversity_penalty > 0.0

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
    # per group: its first beam live at score 0, the rest -inf
    live_scores = torch.full((B, G, Kg), _NEG_INF, device=dev)
    live_scores[:, :, 0] = 0.0
    live_scores = live_scores.reshape(B, K)
    fin_seqs = torch.full((B, K, L), pad_token_id, dtype=torch.long,
                          device=dev)
    fin_scores = torch.full((B, K), _NEG_INF, device=dev)
    stopped = torch.zeros((B, G), dtype=torch.bool, device=dev)
    rank_ok = torch.arange(2 * Kg, device=dev)[None, :] < Kg

    for t in range(1, L):
        with span("decode.step"):
            if "lazy" in state:
                # position t-1 is written this step by each slot itself
                state["lazy"]["ancestry"][:, t - 1] = own_rows
            current = sequences[:, :, t - 1].reshape(B * K)
            logits, state = step_fn(state, current)
            V = logits.shape[-1]
            fused = V > 4096
            if fused:
                lse, bmax = lse_and_block_max(logits)
                if G > 1:
                    # the raw block maxima do not hold under the penalty
                    bmax = None
                    lse_g = lse.reshape(B, G, Kg)
            else:
                logp = torch.log_softmax(logits.float(), dim=-1).reshape(
                    B, K, V)
                if t < min_length:
                    logp[:, :, eos_token_id] = _NEG_INF
                logp = logp.reshape(B, G, Kg, V)
            seqs_g = sequences.reshape(B, G, Kg, L)
            live_g = live_scores.reshape(B, G, Kg)
            fin_seqs_g = fin_seqs.reshape(B, G, Kg, L)
            fin_scores_g = fin_scores.reshape(B, G, Kg)
            token_counts = (torch.zeros((B, V), device=dev) if penalise
                            else None)

            new_beam, new_tok, new_live, new_fin_seqs, new_fin_scores = (
                [], [], [], [], [])
            for g in range(G):
                if fused and G == 1:
                    row_bias = live_scores.reshape(B * K) - lse
                    cand_scores, cand_idx = fused_beam_top_k(
                        logits, row_bias, K, 2 * K,
                        suppress_token=eos_token_id, suppress=t < min_length,
                        block_max=bmax)
                elif fused:
                    # group g's rows only, the penalty a per-(batch, token)
                    # bias over them
                    lg = logits.reshape(B, G, Kg, V)[:, g].reshape(B * Kg, V)
                    lg = lg.float()
                    if penalise:
                        lg = lg - (diversity_penalty * token_counts
                                   ).repeat_interleave(Kg, dim=0)
                    row_bias = (live_g[:, g].reshape(B * Kg)
                                - lse_g[:, g].reshape(B * Kg))
                    cand_scores, cand_idx = fused_beam_top_k(
                        lg, row_bias, Kg, 2 * Kg,
                        suppress_token=eos_token_id, suppress=t < min_length)
                else:
                    lp = logp[:, g]
                    if penalise:
                        lp = lp - diversity_penalty * token_counts[:, None, :]
                    total = live_g[:, g][:, :, None] + lp       # [B, Kg, V]
                    cand_scores, cand_idx = top_k(total.reshape(B, Kg * V),
                                                  2 * Kg)
                cand_beam = cand_idx // V
                cand_tok = cand_idx % V
                is_eos = cand_tok == eos_token_id

                # finished candidates: length-normalised score
                norm = cand_scores / _length_norm(t, length_penalty)
                fin_cand = norm.masked_fill(~is_eos, _NEG_INF)
                if hf_compat:
                    fin_cand = fin_cand.masked_fill(
                        ~rank_ok | stopped[:, g][:, None], _NEG_INF)
                cand_seqs = seqs_g[:, g].gather(
                    1, cand_beam[:, :, None].expand(B, 2 * Kg, L)).clone()
                cand_seqs[:, :, t] = cand_tok
                top_fin_scores, top_fin_idx = top_k(
                    torch.cat([fin_scores_g[:, g], fin_cand], dim=1), Kg)
                new_fin_seqs.append(
                    torch.cat([fin_seqs_g[:, g], cand_seqs], dim=1).gather(
                        1, top_fin_idx[:, :, None].expand(B, Kg, L)))
                new_fin_scores.append(top_fin_scores)

                # live continuation: best Kg non-EOS candidates
                top_live_scores, top_live_idx = top_k(
                    cand_scores.masked_fill(is_eos, _NEG_INF), Kg)
                sel_tok = cand_tok.gather(1, top_live_idx)
                if penalise:
                    token_counts.scatter_add_(
                        1, sel_tok, torch.ones(sel_tok.shape, device=dev))
                new_beam.append(cand_beam.gather(1, top_live_idx) + g * Kg)
                new_tok.append(sel_tok)
                new_live.append(top_live_scores)

            beam_idx = torch.cat(new_beam, dim=1)                  # [B, K]
            live_scores = torch.cat(new_live, dim=1)
            fin_seqs = torch.stack(new_fin_seqs, dim=1).reshape(B, K, L)
            fin_scores = torch.stack(new_fin_scores, dim=1).reshape(B, K)
            sequences = sequences.gather(
                1, beam_idx[:, :, None].expand(B, K, L)).clone()
            sequences[:, :, t] = torch.cat(new_tok, dim=1)
            state = _gather_state(state,
                                  (rows_b * K + beam_idx).reshape(B * K))

            if hf_compat:
                fin_g = fin_scores.reshape(B, G, Kg)
                all_finished = (fin_g > _NEG_INF / 2).all(dim=2)
                best_running = (live_scores.reshape(B, G, Kg).max(dim=2).values
                                / _length_norm(t, length_penalty))
                stopped = stopped | (all_finished & (
                    best_running <= fin_g.min(dim=2).values))
                if _all_done(stopped):
                    break

    # merge unfinished live beams (normalised at full length) with finished
    live_norm = live_scores / (float(L - 1) ** length_penalty)
    if hf_compat:
        live_norm = live_norm.masked_fill(
            stopped.repeat_interleave(Kg, dim=1), _NEG_INF)
    top_scores, top_idx = top_k(torch.cat([fin_scores, live_norm], dim=1), K)
    top_seqs = torch.cat([fin_seqs, sequences], dim=1).gather(
        1, top_idx[:, :, None].expand(B, K, L))
    if return_all:
        return BeamResult(top_seqs, top_scores)
    return BeamResult(top_seqs[:, 0], top_scores[:, 0])


# ---------------------------------------------------------------------------
# High-level entry: decode according to an InferenceConfig
# ---------------------------------------------------------------------------


def decode(step_fn, init_state, batch_size: int, inference_config,
           bos_token_id: int, eos_token_id: int, pad_token_id: int,
           generator: Optional[torch.Generator] = None,
           max_length: Optional[int] = None, return_all: bool = False):
    """Decode with ``inference_config.decoding_strategy``: ``greedy``,
    ``nucleus`` (from ``generator``; without one, a generator on the
    state's device seeded 0, as the JAX package falls back to
    ``PRNGKey(0)``) or ``beam`` (with its groups); tokens ``[B, L]``, or
    with ``beam`` and ``return_all`` the whole :class:`BeamResult`. Any
    other strategy raises ``ValueError``."""
    ic = inference_config
    L = max_length or ic.max_length
    strategy = ic.decoding_strategy
    if strategy == "greedy":
        return greedy_decode(step_fn, init_state, batch_size, bos_token_id,
                             L, eos_token_id=eos_token_id,
                             pad_token_id=pad_token_id,
                             min_length=ic.min_length)
    if strategy == "nucleus":
        if generator is None:
            generator = torch.Generator(
                device=_device(init_state)).manual_seed(0)
        return sample_decode(step_fn, init_state, generator, batch_size,
                             bos_token_id, eos_token_id, pad_token_id, L,
                             temperature=ic.temperature, top_p=ic.top_p,
                             min_length=ic.min_length).tokens
    if strategy == "beam":
        res = beam_search(step_fn, init_state, batch_size, ic.beam_size,
                          bos_token_id, eos_token_id, pad_token_id, L,
                          length_penalty=ic.length_penalty,
                          min_length=ic.min_length,
                          num_beam_groups=ic.num_beam_groups,
                          diversity_penalty=ic.diversity_penalty,
                          return_all=return_all)
        return res if return_all else res.tokens
    raise ValueError(f"Unknown decoding strategy: {strategy}")


def batch_size_of(images) -> int:
    """The batch size of model inputs: an NHWC batch's first dimension, or
    a region-feature dict's ``region_mask`` rows."""
    if isinstance(images, dict):
        return images["region_mask"].shape[0]
    return images.shape[0]


@torch.inference_mode()
def decode_images(model, images, config,
                  generator: Optional[torch.Generator] = None,
                  candidates: bool = False, step_fn=None):
    """The captions of a batch of uint8 images (or normalised float ones,
    or a region-feature dict) on ``model``'s device (the JAX CLI's
    ``_make_decode_batch``): one ``init_cache``, then
    ``config.inference``'s strategy's tokens [B, L] or, with
    ``candidates``, ``max(beam_size, num_candidates)`` beams of which the
    first ``num_candidates`` return as [B, num_candidates, L] for the CLIP
    reranker (the reference's candidate generator is beam search). The
    nucleus strategy draws from ``generator``: pass one for a whole run,
    so that each batch draws anew. ``step_fn`` stands in for
    ``model.step`` (the server counts the steps through it). The eval and
    demo CLIs, validation and the server all decode here."""
    mc, ic = config.model, config.inference
    ids = (mc.bos_token_id, mc.eos_token_id, mc.pad_token_id)
    step_fn = step_fn or model.step
    B = batch_size_of(images)
    with span("decode.encode"):
        state = model.init_cache(images, ic.max_length)
    if candidates:
        res = beam_search(step_fn, state, B,
                          max(ic.beam_size, ic.num_candidates), *ids,
                          ic.max_length, length_penalty=ic.length_penalty,
                          min_length=ic.min_length,
                          num_beam_groups=ic.num_beam_groups,
                          diversity_penalty=ic.diversity_penalty,
                          return_all=True)
        return res.tokens[:, :ic.num_candidates]
    return decode(step_fn, state, B, ic, *ids, generator=generator)
