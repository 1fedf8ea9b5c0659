"""First-class attention mask families (DESIGN.md §12).

The port's copy of ``repro.core.mask`` (numpy only), kept so the port
never imports the JAX package.

A :class:`MaskSpec` names the *shape* of core attention beyond the packed
segment/causal baseline: which kv positions of a document each query
position may see.  Three families are supported, all causal subsets:

  causal   — dense lower triangle per document (the default; every prior
             scenario in this repo)
  sliding  — ``window`` trailing tokens, plus an optional ``sink`` of
             always-visible leading tokens (StreamingLLM-style)
  dilated  — block-strided sparsity at the kernel tile granularity: a
             query block with in-document index ``i`` sees kv blocks ``j``
             with ``(i - j) % rate == 0`` (causal within the block pair)

Everything downstream consumes the spec through three views that are kept
mutually consistent (the property suite in ``tests/test_block_mask.py``
asserts it):

  * :func:`pair_visible` — token-level predicate on in-document positions,
    usable from numpy and torch; the oracle, the plain server versions
    and the CUDA kernels' in-block masks all add this same term.
  * :func:`live_block_mask` / :func:`live_block_table` — block-level
    liveness mirroring the kernels' *pruning* predicates (a conservative
    superset of token visibility: a pruned-in block may still be fully
    masked at the token level, but it is iterated and therefore costed).
  * cost/planning — ``core/scheduler.py`` prices a task at in-document
    q-block ``bi`` by ``live_block_table(...)[bi] * blk`` live kv tokens
    instead of the dense prefix ``(bi + 1) * blk`` (DESIGN.md §12).

Malformed specs raise :class:`MaskSpecError` naming the offending
parameter, task, or segment instead of failing as a shape error deep in a
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MASK_KINDS = ("causal", "sliding", "dilated")


class MaskSpecError(ValueError):
    """A mask spec (or spec × layout combination) is malformed.

    Carries the offending ``segment`` / ``task`` when the failure is tied
    to a specific document or q-block so callers (and error messages) can
    point at data, not just at the spec string.
    """

    def __init__(self, detail: str, *, segment=None, task=None):
        self.segment = segment
        self.task = task
        msg = detail
        if segment is not None:
            msg += f" (segment {segment})"
        if task is not None:
            msg += f" (task {task})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """One attention mask family with its parameters (DESIGN.md §12).

    window / sink are in tokens; rate is in kernel blocks.  The spec is
    hashable and is threaded as a static argument into kernels, planner
    kwargs, and :class:`~repro_torch.core.dispatch.CADContext`.
    """
    kind: str = "causal"
    window: int = 0
    sink: int = 0
    rate: int = 1

    def __post_init__(self):
        if self.kind not in MASK_KINDS:
            raise MaskSpecError(
                f"unknown mask kind {self.kind!r} (choose from "
                f"{', '.join(MASK_KINDS)})")
        if self.kind == "causal":
            if self.window or self.sink or self.rate != 1:
                raise MaskSpecError(
                    "causal mask takes no window/sink/rate parameters")
        elif self.kind == "sliding":
            if self.window <= 0:
                raise MaskSpecError(
                    "zero-live-block mask: sliding needs window > 0 "
                    f"(got {self.window})")
            if self.sink < 0:
                raise MaskSpecError(f"sink must be >= 0 (got {self.sink})")
            if self.rate != 1:
                raise MaskSpecError("sliding mask does not take rate")
        else:  # dilated
            if self.rate < 1:
                raise MaskSpecError(
                    "zero-live-block mask: dilated needs rate >= 1 "
                    f"(got {self.rate})")
            if self.window or self.sink:
                raise MaskSpecError(
                    "dilated mask does not take window/sink")

    @property
    def trivial(self) -> bool:
        """True when the spec is plain dense-causal (no extra terms)."""
        return self.kind == "causal"

    def describe(self) -> str:
        if self.kind == "causal":
            return "causal"
        if self.kind == "sliding":
            s = f"sliding:window={self.window}"
            return s + (f",sink={self.sink}" if self.sink else "")
        return f"dilated:rate={self.rate}"


def parse_mask(text: Optional[str]) -> MaskSpec:
    """Parse a ``--mask`` flag value into a :class:`MaskSpec`.

    Grammar: ``kind[:key=int,...]`` — e.g. ``causal``,
    ``sliding:window=256,sink=16``, ``dilated:rate=4``.
    """
    if not text:
        return MaskSpec()
    kind, _, rest = text.strip().partition(":")
    kw = {}
    if rest:
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in ("window", "sink", "rate"):
                raise MaskSpecError(
                    f"bad mask parameter {part!r} in {text!r} "
                    "(expected window=/sink=/rate=)")
            try:
                kw[key] = int(val)
            except ValueError:
                raise MaskSpecError(
                    f"mask parameter {key}={val!r} is not an integer")
    return MaskSpec(kind=kind.strip(), **kw)


def mask_params(spec: Optional[MaskSpec], window: int = 0):
    """Unpack a spec into the ``(window, sink, rate)`` static ints the
    kernels take.  A trivial/absent spec passes the caller's own
    ``window`` through unchanged (the pre-mask layer-local sliding
    window); a non-trivial spec overrides it."""
    if spec is None or spec.trivial:
        return window, 0, 1
    if spec.kind == "sliding":
        return spec.window, spec.sink, 1
    return 0, 0, spec.rate


def spec_from_params(window: int = 0, sink: int = 0,
                     rate: int = 1) -> Optional[MaskSpec]:
    """Reconstruct the non-trivial :class:`MaskSpec` encoded by unpacked
    kernel params (``window``/``sink``/``rate`` static ints), or None when
    they encode plain causal or causal+window — both of which the original
    ``window`` code paths already handle without a spec."""
    if rate and rate > 1:
        return MaskSpec(kind="dilated", rate=rate)
    if sink and sink > 0:
        return MaskSpec(kind="sliding", window=window, sink=sink)
    return None


# ----------------------------------------------------------- token level
def pair_visible(spec: Optional[MaskSpec], pq, pk, blk: int):
    """Extra visibility term beyond segment + causal, or None if trivial.

    ``pq`` / ``pk`` are broadcast-compatible *in-document* position arrays
    (numpy or torch — only operators are used).  ``blk`` is the block
    granularity the dilated family strides over.  The caller ANDs the
    result into its segment/causal/validity mask; causal specs contribute
    nothing (return None) so trivial paths stay byte-identical to the
    pre-mask code.
    """
    if spec is None or spec.trivial:
        return None
    if spec.kind == "sliding":
        m = (pq - pk) < spec.window
        if spec.sink:
            m = m | (pk < spec.sink)
        return m
    # dilated: block-strided on in-document block indices
    return ((pq // blk) - (pk // blk)) % spec.rate == 0


# ----------------------------------------------------------- block level
def live_block_mask(spec: Optional[MaskSpec], nq_blocks: int,
                    nkv_blocks: int, blk: int) -> np.ndarray:
    """[nq, nkv] bool: kv block ``j`` is priced live for q block ``i``.

    Mirrors the packed kernel's block-pruning predicates; the CA-server
    kernels prune with an exact any-pair-visible test on the actual
    position vectors, which is a subset of this table — so the cost
    model's live count is a tight conservative upper bound on the blocks
    a kernel executes (it can over-count a sliding-window boundary block
    by at most one per row, never under-count).  Sliding keeps block
    ``j`` when its last token could fall inside the window of q block
    ``i``'s first token (``(j+1)*blk - 1 >= i*blk - window``).
    """
    i = np.arange(nq_blocks, dtype=np.int64)[:, None]
    j = np.arange(nkv_blocks, dtype=np.int64)[None, :]
    live = j <= i
    if spec is None or spec.trivial:
        return live
    if spec.kind == "sliding":
        w = (j + 1) * blk - 1 >= i * blk - spec.window
        if spec.sink:
            w = w | (j * blk < spec.sink)
        return live & w
    return live & (((i - j) % spec.rate) == 0)


def live_block_table(spec: Optional[MaskSpec], max_blocks: int,
                     blk: int) -> np.ndarray:
    """[max_blocks] int64: live kv blocks for in-doc q-block index bi.

    ``table[bi] * blk`` is the live kv token count the cost model prices a
    task by; for the causal spec this reduces to the dense ``bi + 1``
    prefix (DESIGN.md §12).
    """
    if max_blocks <= 0:
        return np.zeros(0, np.int64)
    return live_block_mask(spec, max_blocks, max_blocks, blk).sum(axis=1)


def live_kv_len(spec: Optional[MaskSpec], kv_blocks: int, blk: int) -> int:
    """Live kv tokens for a CA task whose kv prefix is ``kv_blocks`` long.

    Uses the plan invariant that a task's q block has in-document index
    ``kv_blocks - 1`` (its kv range is its document's exact causal
    prefix), so the task's live work is ``table[kv_blocks - 1]`` blocks.
    """
    if kv_blocks <= 0:
        return 0
    if spec is None or spec.trivial:
        return kv_blocks * blk
    return int(live_block_table(spec, kv_blocks, blk)[kv_blocks - 1]) * blk


# ------------------------------------------------------------ validation
def validate_mask_layout(spec: Optional[MaskSpec], segment_ids,
                         blk: int) -> None:
    """Check a spec against a packed layout before planning/kernels.

    ``segment_ids``: [L] or [R, L] int array (0 = padding).  Raises
    :class:`MaskSpecError` naming the offending segment/task for:

      * overlapping segments — a nonzero id that is non-contiguous within
        a row or spans rows (the doc-pure-block invariant every kernel
        index map relies on);
      * segments not aligned to ``blk`` block boundaries;
      * window larger than kv — a sliding window wider than the longest
        document degenerates to dense causal, which is always a config
        mistake (the flag's unit is tokens);
      * zero-live-block tasks — any q block the spec leaves with no live
        kv block (defensive; reachable through hand-built live tables).
    """
    seg = np.asarray(segment_ids)
    if seg.ndim == 1:
        seg = seg[None, :]
    seen_rows = {}
    max_doc_tokens = 0
    for r in range(seg.shape[0]):
        row = seg[r]
        ids = row[row > 0]
        if ids.size == 0:
            continue
        # contiguity: each id must occupy exactly one run within one row
        change = np.flatnonzero(np.diff(row) != 0)
        starts = np.concatenate([[0], change + 1])
        run_ids = row[starts]
        nz = run_ids[run_ids > 0]
        uniq, counts = np.unique(nz, return_counts=True)
        for sid, cnt in zip(uniq.tolist(), counts.tolist()):
            if cnt > 1:
                raise MaskSpecError(
                    "overlapping segments: id occupies multiple runs "
                    f"in row {r}", segment=sid)
            prev = seen_rows.get(sid)
            if prev is not None:
                raise MaskSpecError(
                    f"overlapping segments: id spans rows {prev} and {r}",
                    segment=sid)
            seen_rows[sid] = r
        for s0, sid in zip(starts.tolist(), run_ids.tolist()):
            if sid > 0 and s0 % blk != 0:
                raise MaskSpecError(
                    f"segment start {s0} is not aligned to blk={blk}",
                    segment=sid)
        for sid in uniq.tolist():
            max_doc_tokens = max(max_doc_tokens, int((row == sid).sum()))
    if spec is None or spec.trivial:
        return
    if spec.kind == "sliding" and max_doc_tokens \
            and spec.window > max_doc_tokens:
        longest = max(seen_rows, key=lambda s: int((seg == s).sum()))
        raise MaskSpecError(
            f"window {spec.window} larger than kv: longest document has "
            f"{max_doc_tokens} tokens, the mask degenerates to causal",
            segment=longest)
    nb = max(1, -(-max_doc_tokens // blk))
    tbl = live_block_table(spec, nb, blk)
    dead = np.flatnonzero(tbl == 0)
    if dead.size:
        raise MaskSpecError(
            "zero-live-block task: q block has no live kv blocks",
            task=int(dead[0]))
