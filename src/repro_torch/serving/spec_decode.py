"""Speculative decoding drafters for the serving engine
(``repro/serving/spec_decode.py``, ported).

Decode is memory-bound per token: every step streams the whole resident
KV working set to produce ONE token per slot. Speculative decoding
amortizes that traffic — a cheap **drafter** proposes ``k`` continuation
tokens per request, the target model verifies all of them in a single
masked forward pass (Sq = 1 + k at the slot's current offset — the same
offset-aware kernels that serve chunked prefill), and the engine keeps
the longest prefix of drafts the target's own greedy choice agrees with,
plus the "bonus" token the verify logits supply after the last accepted
draft. Greedy streams are therefore **token-identical** to
non-speculative decoding by construction: every accepted token is the
target's argmax given exactly the tokens before it.

Rejected drafts have already been written into the KV cache by the
verify pass; the engine rolls them back host-side — valid lengths reset
to the accepted count, and in paged mode the block table's wholly-
rejected tail pages return to the pool (:meth:`BlockTable.truncate`,
serving/kv_pool.py). docs/serving.md#speculative-decoding walks the full
accept/rollback lifecycle and its invariants.

Two drafters ship here:

* :class:`NGramDrafter` — prompt-lookup self-speculation: propose the
  continuation that followed the most recent earlier occurrence of the
  stream's current suffix n-gram. Zero model cost (pure host list
  matching), and highly effective on self-similar streams — repetitive
  generations, retrieval-grounded prompts, code.
* :class:`DraftModelDrafter` — a small registry model (e.g.
  ``smollm-135m`` drafting for a larger target) generating ``k`` greedy
  tokens via its own single-slot :class:`~repro_torch.serving.engine
  .ServingEngine` on the same device as the target. The draft
  model's *quality* only moves the acceptance rate, never the output:
  the target verifies every proposal.

Engine wiring: ``ServeConfig(spec=<drafter>)``; the drafter's ``k`` is
the per-step draft budget (the engine may trim it when the page pool or
the ``max_len`` horizon cannot back all drafted positions). With
speculation on, ``ServingEngine.step`` returns ``{handle: [tokens]}`` —
a *burst* of accepted tokens per request — instead of one token each.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter", "make_drafter"]


class Drafter:
    """Interface: propose up to ``k`` continuation tokens for a stream.

    ``context`` is the request's full visible stream — prompt, reported
    output, and the pending (sampled-but-unreported) token — and the
    return value is a list of 0..``k`` proposed next tokens. Returning
    fewer than ``k`` (or ``[]``) is always legal: the engine verifies
    whatever is proposed and falls back to plain one-token decode for a
    slot with no drafts. Proposals must be valid *target* token ids.

    ``k`` on the instance is the engine's per-step draft budget; the
    per-call ``k`` argument may be smaller when the engine trimmed the
    budget to its page pool or ``max_len`` horizon.
    """

    k: int = 4

    def draft(self, context: List[int], k: int) -> List[int]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup self-speculation: match the stream's trailing
    n-gram against its own earlier content and propose the tokens that
    followed the most recent match.

    Tries n-gram sizes from ``ngram`` down to ``min_ngram`` (longer
    matches are more specific, so they are preferred); proposes nothing
    when no earlier occurrence exists — costless honesty, since the
    engine then just decodes normally. Deterministic: the most recent
    match wins, so drafting never depends on iteration order. A match
    whose continuation is cut off by the end of the stream overlaps the
    suffix itself — the stream is locally *periodic* there (constant
    runs, short cycles), so the continuation is extended cyclically to
    the full draft budget; mispredictions only cost acceptance, never
    correctness, and the verify pass is fixed-shape regardless.
    """

    def __init__(self, k: int = 4, ngram: int = 3, min_ngram: int = 1):
        if k < 1 or ngram < min_ngram or min_ngram < 1:
            raise ValueError(
                f"NGramDrafter(k={k}, ngram={ngram}, min_ngram={min_ngram})"
                f" needs k >= 1 and ngram >= min_ngram >= 1")
        self.k = int(k)
        self.ngram = int(ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, context: List[int], k: int) -> List[int]:
        k = min(k, self.k)
        if k < 1:
            return []
        for n in range(min(self.ngram, len(context) - 1),
                       self.min_ngram - 1, -1):
            suffix = context[-n:]
            # scan right-to-left: the most recent earlier occurrence is
            # the best predictor of what follows now
            for i in range(len(context) - n - 1, -1, -1):
                if context[i:i + n] == suffix:
                    start = i + n
                    cont = context[start:start + k]
                    if len(cont) < k:
                        # the continuation runs off the end of the
                        # stream, i.e. the match overlaps the suffix:
                        # the stream is locally periodic with period
                        # len - n - i (a constant run is period 1) —
                        # extend cyclically to the full budget
                        p = len(context) - n - i
                        cont = [context[start + (j % p)]
                                for j in range(k)]
                    return [int(t) for t in cont]
        return []


class DraftModelDrafter(Drafter):
    """Draft with a small registry model: ``k`` greedy tokens from its
    own single-slot serving engine (dense contiguous cache — the draft
    model re-prefills the context each call, so target-side rollback
    never needs mirroring into draft state).

    Each ``draft()`` call is one bucketed masked prefill of the context
    plus ``k - 1`` decode steps. Acceptance tracks how well the draft
    model's greedy choices agree with the target's; a perfectly-agreeing
    drafter (e.g. the target itself, in tests) accepts everything.
    """

    def __init__(self, cfg, params, k: int = 4, max_len: int = 2048,
                 attention=None, device: str = "cuda", pack_weights=False):
        from repro_torch.serving.engine import ServeConfig, ServingEngine
        if k < 1:
            raise ValueError(f"DraftModelDrafter k must be >= 1, got {k}")
        self.k = int(k)
        self.cfg = cfg
        # headroom: context up to the target's max_len, plus the drafts.
        # ``attention`` picks the draft engine's backend — matching the
        # target's backend maximizes argmax agreement on near-tied logits
        # (acceptance is exact-match; cross-backend float rounding can
        # flip a tie and cost an otherwise-good draft).
        self._eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=1, max_len=int(max_len) + self.k + 2,
            cache_dtype=cfg.dtype, attention=attention, device=device,
            pack_weights=pack_weights))

    def draft(self, context: List[int], k: int) -> List[int]:
        k = min(k, self.k)
        if k < 1 or not context:
            return []
        eng = self._eng
        if len(context) >= eng.sc.max_len:
            return []                  # context outgrew the draft horizon
        handle = eng.submit(list(context))
        if handle is None:             # single slot — cannot happen, but
            return []                  # degrade to no drafts, never raise
        out: List[int] = []
        for _ in range(k):
            stepped = eng.step()
            if handle not in stepped:
                break
            out.append(int(stepped[handle]))
        eng.cancel(handle)
        return out


def make_drafter(spec: str, *, k: int = 4, max_len: int = 2048,
                 smoke: bool = False, seed: int = 0,
                 draft_params=None, device: str = "cuda",
                 pack_weights: bool = False) -> Drafter:
    """Build a drafter from a CLI-style spec string
    (``launch/serve.py --spec``):

    * ``"ngram"`` → :class:`NGramDrafter` with draft budget ``k``;
    * ``"draft:<arch>"`` → :class:`DraftModelDrafter` over the registry
      model ``<arch>`` (smoke-sized when ``smoke``) on ``device``.
      ``draft_params`` supplies trained weights; absent, the model is
      randomly initialized from ``seed`` (``T.init_model``) — a wiring
      demo, with the acceptance rate to match.
    """
    if spec == "ngram":
        return NGramDrafter(k=k)
    if spec.startswith("draft:"):
        from repro_torch.configs.registry import get_config, get_smoke_config
        from repro_torch.models import transformer as T
        arch = spec[len("draft:"):]
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        params = draft_params
        if params is None:
            params = T.init_model(cfg, seed=seed, device=device)
        return DraftModelDrafter(cfg, params, k=k, max_len=max_len,
                                 device=device, pack_weights=pack_weights)
    raise ValueError(
        f"unknown drafter spec {spec!r} (expected 'ngram' or "
        f"'draft:<arch>')")
