"""Speculative decoding: truncated-cascade self-drafting and one batched
verify a tick (port of :mod:`repro.spec`).

A cheap *draft* proposes ``k`` tokens a slot, the target scores all of
them in ONE append-and-score pass (``dist.steps.make_verify_step``;
paged, through the paged-attention kernel at T = k + 1), and the engine
advances each slot by its accepted prefix plus one token.  The default
draft is the paper's depth result put to work: the target's own weights
with every ACDC cascade cut to its first layers
(:class:`~repro_torch.spec.draft.TruncatedCascadeDraft`); any config with
the same vocabulary can draft instead
(:class:`~repro_torch.spec.draft.ModelDraft`).

Contract (pinned by tests/test_torch_spec.py against the reference):

* **greedy**: a draft token is accepted iff it equals the target argmax
  at its position, so the committed stream is the non-speculative
  engine's whatever the draft proposes;
* **temperature**: rejection sampling (accept ``d_i`` with probability
  ``min(1, p(d_i)/q(d_i))``, resample the first rejection from
  ``norm(max(p - q, 0))``, bonus token from ``p``), which keeps the
  target's sampling distribution;
* **rollback**: KV caches are set-written, so a position rewind suffices
  (dense) plus returning over-mapped tail pages to the allocator (paged).
"""

from repro_torch.spec.draft import (  # noqa: F401
    DraftSource,
    ModelDraft,
    TruncatedCascadeDraft,
    truncate_cascades,
)
from repro_torch.spec.verify import (  # noqa: F401
    commit_states,
    committed_tokens,
    greedy_accept,
    rejection_accept,
)
