"""Vote-based candidate frame search over the sorted descriptor DB.

JAX re-design of ``STDescManager::candidate_selector``
(src/sgtd/src/STDesc.cpp:318-460). The reference probes 27 hash buckets per
query descriptor under OpenMP and accumulates votes in a fixed array; here the
same computation is one fused tensor program:

  probe keys (27 per descriptor)  ->  searchsorted bucket ranges
  ->  gathered bucket rows        ->  side-length rough filter
  ->  per-frame vote segment_sum  ->  top-K candidate frames
  ->  per-candidate match-pair extraction (sort hits by frame, slice).

Vote parity: every bucket entry within ``bucket_cap`` is counted, with the
same gates as the reference — bucket-key equality (labels included in the
key), the 1.5-cell voxel-centre gate (STDesc.cpp:369), and
``dist(sides) < ||sides|| * rough_dis_threshold`` (STDesc.cpp:356,378).
The reference's ``frame_id`` ordering check (STDesc.cpp:373) is a loop-closure
guard that is always true in one-shot localization (query is never in the DB)
and is intentionally not reproduced.

The three stages are exposed separately so the multi-device path
(sgtd_tpu.parallel.sharded_match) can run stage 1 on DB shards, psum the
votes, and all-gather the pair lists.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sgtd_tpu.config import CapacityConfig, DescriptorConfig, SearchConfig
from sgtd_tpu.db.database import DescriptorDB
from sgtd_tpu.desc.keys import probe_cells, _N_CODES
from sgtd_tpu.desc.triangles import Descriptors
import numpy as np

_I32_MAX = np.int32(2**31 - 1)


def frame_votes(hit: jnp.ndarray, frame: jnp.ndarray, f_pad: int) -> jnp.ndarray:
    """Per-frame vote tally (ref match_array, STDesc.cpp:410-412): number
    of ``hit`` slots per ``frame`` id, (f_pad,) float32. Ids outside
    [0, f_pad) count nothing. An int32 scatter-add: exact, and independent
    of the order in which the adds land."""
    votes = jnp.zeros(f_pad, jnp.int32).at[frame].add(
        hit.astype(jnp.int32), mode="drop"
    )
    return votes.astype(jnp.float32)


class CandidateSet(NamedTuple):
    """Top-K candidate frames and their match-pair lists.

    frames:     (C,) int32 — candidate keyframe ids (vote-descending).
    votes:      (C,) float32 — vote tallies.
    valid:      (C,) bool — vote >= min_votes (ref STDesc.cpp:433).
    pair_qidx:  (C, P) int32 — query-descriptor index of each match pair.
    pair_row:   (C, P) int32 — DB row of each match pair.
    pair_valid: (C, P) bool.
    truncated:  () int32 bitmask — TRUNC_SCAN: the ragged probe scan
                overflowed caps.max_scan_slots (votes may be undercounted);
                TRUNC_PAIRS: some descriptor had more than
                hits_per_descriptor hits (votes exact; its pair list is
                STRIDED-subsampled, the reference's skip_len semantics).
                0 = the query ran within every static cap.
    """

    frames: jnp.ndarray
    votes: jnp.ndarray
    valid: jnp.ndarray
    pair_qidx: jnp.ndarray
    pair_row: jnp.ndarray
    pair_valid: jnp.ndarray
    truncated: jnp.ndarray


# Truncation bitmask values (CandidateSet.truncated / LocalizationResult).
TRUNC_SCAN = 1  # ragged scan overflowed max_scan_slots: votes may be lost
TRUNC_PAIRS = 2  # hits_per_descriptor exceeded: pair lists strided-subsampled


class ProbeHits(NamedTuple):
    """Stage-1 output of :func:`probe_and_hits`.

    votes:     (F,) float32 per-frame vote tally (exact unless scan_overflow).
    sel_row:   (D, U) int32 compacted DB row per kept hit — None when the
               caller requested ``with_sel=False`` (candidate-major pair
               extraction, used at scale where the L-sized sel scatter
               dominates; see CapacityConfig.sel_max_scan_slots).
    sel_frame: (D, U) int32 frame of each kept hit (F = empty slot); None
               with ``with_sel=False``.
    scan_overflow: () bool — probe total exceeded caps.max_scan_slots.
    pair_overflow: () bool — some descriptor's hits were strided-subsampled.
    """

    votes: jnp.ndarray
    sel_row: jnp.ndarray
    sel_frame: jnp.ndarray
    scan_overflow: jnp.ndarray
    pair_overflow: jnp.ndarray


def _frame_of_rows(db: DescriptorDB, rows: jnp.ndarray) -> jnp.ndarray:
    """Owning keyframe of DB rows.

    Fast path reads the frame id packed into the high 16 bits of packed2
    word 1; DBs beyond 65536 keyframes (frame ids unpackable — the
    reference's hard MAX_FRAME_N=20000 ceiling, STDesc.h:33, lifted here)
    fall back to one extra int32 gather from frame_ids. The choice is
    static (array shapes).
    """
    if db.frame_poses.shape[0] > 65536:
        return db.frame_ids[rows]
    return (db.packed2[rows, 1] >> 16).astype(jnp.int32)


def _bucket_lookup(
    db: DescriptorDB,
    cells: jnp.ndarray,
    code: jnp.ndarray,
    probe_ok: jnp.ndarray,
    row_offset: jnp.ndarray | None,
):
    """(start, end) row range of each (cell, code) probe bucket.

    Fast path: the DB's direct-addressed bucket table — three independent
    gathers (cell remap, code remap, one (start, len) 8-byte slice).
    Fallback (DB beyond 2^31 rows or the table-slot budget): the sequential
    in-cell binary search over the sorted codes (16 dependent gathers;
    kept for unbounded generality).

    With ``row_offset`` the returned ranges are clipped into this shard's
    local rows (ranges are stored globally; a bucket split across shards is
    scanned partly on each side).
    """
    m_rows = db.keys.shape[0]
    if db.bucket_table.shape[0] > 0:
        dc = db.cell_remap[cells]  # (D, 27)
        dk = db.code_remap[jnp.clip(code, 0, db.code_remap.shape[0] - 1)]
        ok = probe_ok & (dc >= 0) & (dk >= 0)[..., None]
        idx = jnp.where(ok, dc * db.table_stride[0] + dk[..., None], 0)
        word2 = db.bucket_table[idx]  # (..., 2): one 8B slice gather
        start = word2[..., 0].astype(jnp.int32)
        end = start + jnp.where(ok, word2[..., 1].astype(jnp.int32), 0)
        if row_offset is not None:
            start = jnp.clip(start - row_offset, 0, m_rows)
            end = jnp.clip(end - row_offset, 0, m_rows)
    else:
        cs = db.cell_start[cells]
        ce = db.cell_start[cells + 1]
        if row_offset is not None:
            # Shard-local view first: the codes bisected below are this
            # shard's rows. A cell split across shards stays code-sorted
            # within each contiguous chunk.
            cs = jnp.clip(cs - row_offset, 0, m_rows)
            ce = jnp.clip(ce - row_offset, 0, m_rows)
        code2 = jnp.stack([code, code + 1])[:, :, None]  # (2, D, 1)

        def step(_, state):
            lo, hi = state
            active = lo < hi
            mid = (lo + hi) >> 1
            cmid = db.codes[jnp.minimum(mid, m_rows - 1)]
            go_right = cmid < code2
            lo = jnp.where(active & go_right, mid + 1, lo)
            hi = jnp.where(active & ~go_right, mid, hi)
            return lo, hi

        # Step count derived from the static table size: ceil(log2(M))
        # covers any cell (a cell cannot hold more rows than the table) —
        # no fixed per-cell capacity ceiling. Rolled loop: an unrolled
        # gather chain sends XLA:CPU compilation into the weeds
        # (>minutes).
        steps = max(int(np.ceil(np.log2(max(m_rows, 2)))), 1)
        lo2 = jnp.broadcast_to(cs, (2,) + cs.shape)
        hi2 = jnp.broadcast_to(ce, (2,) + ce.shape)
        lo2, _ = jax.lax.fori_loop(0, steps, step, (lo2, hi2))
        start, end = lo2[0], lo2[1]
        ok = probe_ok
    return start, end, ok


def probe_and_hits(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig,
    search: SearchConfig,
    caps: CapacityConfig,
    row_offset: jnp.ndarray | None = None,
    with_sel: bool = True,
) -> ProbeHits:
    """Stage 1: bucket probes + rough filter on (a shard of) the DB.

    Returns a :class:`ProbeHits`: votes (F,), sel_row (D, U), sel_frame
    (D, U) — sel_frame holds the frame id of each kept hit or F (sentinel)
    for empty slots — plus the two overflow flags. The vote tally counts
    *all* hits (exact parity) unless ``scan_overflow``; sel_* is the
    compacted per-descriptor hit list used only for verification pair lists.

    ``row_offset``: when the DB rows are a contiguous shard of a larger
    table, the global row index of this shard's first row — the (global)
    cell_start offsets are clipped into the local range.
    """
    d_max = query.sides.shape[0]
    # The packed (desc << 15 | side_c) expansion below needs desc ids to fit
    # 16 bits alongside the 15-bit side without int32 overflow. Static-shape
    # check at trace time; a plain assert would vanish under `python -O`
    # and overflow silently (ADVICE r3).
    if d_max > 1 << 16:
        raise ValueError(
            f"caps.max_descriptors={d_max} exceeds the packed-expansion "
            "bound (65536): descriptor ids must fit 16 bits alongside the "
            "15-bit fixed-point side in one int32 word"
        )

    m_rows = db.keys.shape[0]

    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (D, 27)
    start, end, probe_ok = _bucket_lookup(
        db, cells, code, gate & query.mask[:, None], row_offset
    )

    # --- ragged (CSR-style) bucket scan. ---
    # Bucket depths are highly skewed; a dense (D, 27, max_bucket) scan is
    # ~90% padding. Instead the exact per-probe bucket lengths expand into
    # one flat job list, so gather/scatter work equals the true total bucket
    # occupancy, padded only up to the static caps.max_scan_slots. The
    # expansion is NOT jnp.repeat (whose lowering binary-searches every slot
    # into the offset table):
    # per-slot row and descriptor ids are rebuilt exactly from scatter-added
    # integer deltas at the segment heads followed by one cumsum — the
    # telescoping sum reproduces each segment's base even when empty
    # segments share a head slot, and a segment straddling the cap is
    # truncated exactly like repeat would (heads past the cap scatter out
    # of bounds and drop, as do their slots). The lookup above lands on the
    # exact (cell, code) bucket, so no code re-check is needed; sides +
    # frame come from one 8-byte packed-word gather per row (16-bit fixed
    # point).
    length = jnp.where(probe_ok, end - start, 0).ravel()  # (D*27,)
    n_jobs = d_max * 27
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(length, dtype=jnp.int32)]
    )  # (D*27+1,)
    total = offsets[-1]
    l_max = caps.max_scan_slots
    slot = jnp.arange(l_max, dtype=jnp.int32)
    slot_valid = slot < total
    heads = offsets[:-1]  # (D*27,) head slot of each job segment

    def _expand(per_job):
        """Per-slot value of a per-job quantity via delta scatter + cumsum."""
        delta = jnp.concatenate([per_job[:1], per_job[1:] - per_job[:-1]])
        buf = jnp.zeros(l_max, jnp.int32).at[heads].add(delta, mode="drop")
        return jnp.cumsum(buf)

    job_desc = jnp.arange(n_jobs, dtype=jnp.int32) // 27

    # Rough side-length filter in the DB's own 1/256 fixed-point grid. The
    # query sides are quantised to the same grid (max perturbation 1/512 of
    # a cell — two orders below the rough threshold) so the per-slot query
    # values expand through the exact integer delta/cumsum machinery
    # instead of four more L-sized random gathers (q[desc, k], thr2[desc]);
    # thresholds are recomputed per slot. 15-bit packing holds sides up to
    # 127 cells — beyond the key-space validation bound.
    qq = jnp.clip(jnp.round(query.sides * 256.0), 0, 32767).astype(jnp.int32)
    qq_j = qq[job_desc]  # (NJ, 3) — job-level gather, 27x smaller than L
    # row = (start_j - head_j) + slot within segment j; two more
    # expansions carry all three sides + the descriptor id
    # (delta/cumsum is linear, so the telescoped sum reproduces any
    # PACKED integer exactly): (a << 15 | b) and (desc << 15 | c).
    row = _expand(start.ravel() - heads) + slot
    q_ab = _expand((qq_j[:, 0] << 15) | qq_j[:, 1])
    dq_c = _expand((job_desc << 15) | qq_j[:, 2])
    desc = dq_c >> 15  # nondecreasing
    q_c = dq_c & 32767
    q_a = q_ab >> 15
    q_b = q_ab & 32767

    row_c = jnp.clip(row, 0, m_rows - 1)
    w2 = db.packed2[row_c]  # (L, 2) uint32 — ONE 8-byte slice gather per row
    lo_w = w2[:, 0]
    hi_w = w2[:, 1]
    if db.frame_poses.shape[0] > 65536:
        frame_of_hit = db.frame_ids[row_c]  # wide-frame DB: extra gather
    else:
        frame_of_hit = (hi_w >> 16).astype(jnp.int32)
    da = (lo_w & 0xFFFF).astype(jnp.int32) - q_a
    db_ = (lo_w >> 16).astype(jnp.int32) - q_b
    dc = (hi_w & 0xFFFF).astype(jnp.int32) - q_c
    # int32-safe: sides are <= ~24k fixed-point units (94-cell key-space
    # bound), so the squared sum stays below 2^31.
    dis2 = (da * da + db_ * db_ + dc * dc).astype(jnp.float32)
    qs2 = (q_a * q_a + q_b * q_b + q_c * q_c).astype(jnp.float32)
    thr2 = qs2 * jnp.float32(search.rough_dis_threshold) ** 2
    hit = slot_valid & (dis2 < thr2)  # (L,)

    # --- exact per-frame vote tally. ---
    f_pad = db.frame_poses.shape[0]
    votes = frame_votes(hit, frame_of_hit, f_pad)
    votes = jnp.where(db.frame_valid, votes, 0.0)

    if not with_sel:
        # Candidate-major pair extraction (extract_pairs_by_frame) will
        # build the pair lists — skip the whole per-descriptor compaction
        # (hcum cumsum, rank/stride arithmetic, and the L-sized sel
        # scatter: serialized HBM updates that dominate at scale).
        return ProbeHits(
            votes=votes,
            sel_row=None,
            sel_frame=None,
            scan_overflow=total > l_max,
            pair_overflow=jnp.asarray(False),
        )

    # --- compact hits per query descriptor for pair extraction. ---
    # The tally above is exact; pair lists are bounded by hits_per_descriptor
    # per query descriptor and pairs_per_candidate per frame (the reference
    # also subsamples pairs before verification, STDesc.cpp:467-468).
    # Per-descriptor hit ranks via a segment-relative cumsum (desc ids are
    # nondecreasing along the flat job list).
    u = caps.hits_per_descriptor
    hcum = jnp.cumsum(hit.astype(jnp.int32))  # inclusive
    desc_first_slot = offsets[jnp.arange(d_max) * 27]  # (D,)
    hcum_ext = jnp.concatenate([jnp.zeros((1,), jnp.int32), hcum])
    before_desc = hcum_ext[jnp.clip(desc_first_slot, 0, l_max)]  # (D,)
    rank_in_desc = hcum - 1 - before_desc[desc]  # valid where hit
    # STRIDED subsampling when a descriptor has more than ``u`` hits — the
    # reference's skip_len semantics (STDesc.cpp:467-468) applied per
    # descriptor. Keeping the FIRST u hits instead is frame-id-biased
    # (bucket rows sort frame-ascending within a key), and on aliased maps
    # that starves the true frame's pair list and flips the verification
    # ranking (found by the hard-world oracle-agreement check, round 4).
    # When n_hits <= u the stride is 1 and this is exactly the old keep.
    desc_next_slot = offsets[jnp.arange(1, d_max + 1) * 27]  # (D,)
    after_desc = hcum_ext[jnp.clip(desc_next_slot, 0, l_max)]  # (D,)
    n_hits_d = after_desc - before_desc  # (D,)
    # stride = ceil(n/u): identity for n <= u, and rank//stride < u always.
    stride_j = ((n_hits_d - 1) // u + 1)[job_desc]  # (NJ,) per-job constant
    stride = _expand(stride_j)  # (L,) via the same delta-scatter machinery
    stride = jnp.maximum(stride, 1)
    keep = hit & (rank_in_desc % stride == 0)
    pair_overflow = jnp.any(hit & (stride > 1))
    sd = jnp.where(keep, desc, d_max)  # dump row for non-kept
    si = jnp.where(keep, rank_in_desc // stride, 0)
    # One scatter carries everything: row+1 (0 = empty slot); the frame is
    # re-derived from the (tiny) selected rows afterwards.
    sel = (
        jnp.zeros((d_max + 1, u), jnp.int32).at[sd, si].set(row_c + 1)[:d_max]
    )
    sel_ok = sel > 0
    sel_row = jnp.maximum(sel - 1, 0)
    sel_frame = jnp.where(
        sel_ok, _frame_of_rows(db, sel_row), f_pad
    )
    return ProbeHits(
        votes=votes,
        sel_row=sel_row,
        sel_frame=sel_frame,
        scan_overflow=total > l_max,
        pair_overflow=pair_overflow,
    )


def select_candidates(
    votes: jnp.ndarray, search: SearchConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Stage 2: top-K candidate frames (ref STDesc.cpp:423-453)."""
    f_pad = votes.shape[0]
    k_cand = min(search.candidate_num, f_pad)
    cand_votes, cand_frames = jax.lax.top_k(votes, k_cand)
    cand_valid = cand_votes >= jnp.float32(search.min_votes)
    return cand_votes, cand_frames.astype(jnp.int32), cand_valid


def extract_pairs(
    sel_row: jnp.ndarray,
    sel_frame: jnp.ndarray,
    cand_frames: jnp.ndarray,
    cand_valid: jnp.ndarray,
    pairs_per_candidate: int,
    f_pad: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Stage 3: group hits by frame and slice each candidate's pair list.

    The frame grouping is ONE int32 value sort of (frame * DU + flat_index)
    — stable by construction — instead of a stable argsort + three
    take_along_axis gathers (sorts and random gathers, not FLOPs, bound
    this stage). The packing
    needs (f_pad + 1) * DU < 2^31; wide DBs fall back to argsort.
    """
    d_max, u = sel_frame.shape
    du = d_max * u
    hf = sel_frame.ravel()
    hr = sel_row.ravel()
    if f_pad is not None and (f_pad + 1) * du < 2**31:
        # Packed fast path. hq (the query-descriptor id) is
        # flat_index // u — recomputed from the sorted value, no gather.
        flat = jnp.arange(du, dtype=jnp.int32)
        s = jnp.sort(hf * jnp.int32(du) + flat)
        hf_s = s // jnp.int32(du)
        idx_s = s - hf_s * jnp.int32(du)
        hq_s = idx_s // jnp.int32(u)
        hr_s = hr[idx_s]
    else:
        # Wide-DB fallback (frame * DU would overflow int32).
        hq = jnp.broadcast_to(
            jnp.arange(d_max, dtype=jnp.int32)[:, None], (d_max, u)
        ).ravel()
        order = jnp.argsort(hf, stable=True)
        hf_s, hq_s, hr_s = hf[order], hq[order], hr[order]

    p = pairs_per_candidate
    lo = jnp.searchsorted(hf_s, cand_frames)  # (C,)
    pair_pos = lo[:, None] + jnp.arange(p, dtype=jnp.int32)[None, :]  # (C, P)
    pair_pos_c = jnp.minimum(pair_pos, du - 1)
    pair_valid = (
        (pair_pos < du)
        & (hf_s[pair_pos_c] == cand_frames[:, None])
        & cand_valid[:, None]
    )
    return hq_s[pair_pos_c], hr_s[pair_pos_c], pair_valid


@functools.partial(jax.jit, static_argnames=("cfg", "search", "caps"))
def candidate_search(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig = DescriptorConfig(),
    search: SearchConfig = SearchConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> CandidateSet:
    # Static strategy switch (see CapacityConfig.sel_max_scan_slots): at
    # scale the per-descriptor sel compaction is an L-sized serialized
    # scatter; candidate-major extraction costs O(C x rows-per-frame)
    # independent of L and yields EXACT per-frame pair lists.
    use_sel = caps.max_scan_slots <= caps.sel_max_scan_slots
    ph = probe_and_hits(db, query, cfg, search, caps, with_sel=use_sel)
    cand_votes, cand_frames, cand_valid = select_candidates(ph.votes, search)
    if use_sel:
        pair_qidx, pair_row, pair_valid = extract_pairs(
            ph.sel_row, ph.sel_frame, cand_frames, cand_valid,
            caps.pairs_per_candidate, f_pad=db.frame_poses.shape[0],
        )
    else:
        pkeys, pdesc = build_probe_table(query, cfg)
        pair_qidx, pair_row, pair_valid = extract_pairs_by_frame(
            db, query, pkeys, pdesc, cand_frames, cand_valid, search, caps
        )
    truncated = (
        ph.scan_overflow.astype(jnp.int32) * TRUNC_SCAN
        + ph.pair_overflow.astype(jnp.int32) * TRUNC_PAIRS
    )
    return CandidateSet(
        frames=cand_frames,
        votes=cand_votes,
        valid=cand_valid,
        pair_qidx=pair_qidx,
        pair_row=pair_row,
        pair_valid=pair_valid,
        truncated=truncated,
    )


def fit_scan_slots(observed_max: int, config, margin: float = 1.5):
    """Turn an observed max probe-scan total into a fitted caps config.

    8192-slot granularity instead of powers of two: every probe-stage op
    (the packed-word gathers, the delta-scatter expansions, the rough
    filter, the vote segment-sum) scales linearly with the cap, and pow2
    rounding wasted up to 2x (e.g. a 75k-slot workload padding to 131072
    instead of 114688).
    """
    fitted = max(8192, -(-int(observed_max * margin) // 8192) * 8192)
    caps = dataclasses.replace(
        config.caps, max_scan_slots=min(fitted, config.caps.max_scan_slots)
    )
    return config.replace(caps=caps)


# ---- optional candidate-major pair extraction (exact per-frame pair
# lists like the reference's match_list; ~2.5x slower than the U-capped
# default at bench scale, useful when per-descriptor caps bite) ----

def _bisect(sorted_keys: jnp.ndarray, targets: jnp.ndarray, lo, hi, steps: int):
    """Vectorised lower_bound over a sorted array with given ranges.

    Rolled loop: an unrolled gather chain sends XLA:CPU compilation into the
    weeds (>minutes).
    """
    m = sorted_keys.shape[0]

    def step(_, state):
        lo, hi = state
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = sorted_keys[jnp.minimum(mid, m - 1)]
        go_right = kmid < targets
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, _ = jax.lax.fori_loop(0, steps, step, (lo, hi))
    return lo


def probe_ranges(
    db: DescriptorDB,
    query: Descriptors,
    cfg: DescriptorConfig,
    row_offset: jnp.ndarray | None = None,
):
    """(start, end) row ranges of each (descriptor, probe) bucket, plus the
    probe validity mask. Ranges are shard-local when row_offset is given."""
    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (D, 27)
    return _bucket_lookup(db, cells, code, gate & query.mask[:, None], row_offset)



def build_probe_table(
    query: Descriptors, cfg: DescriptorConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sorted (probe key, descriptor id) table for the pair pass."""
    cells, code, gate = probe_cells(query.sides, query.labels, cfg)  # (D, 27)
    ok = gate & query.mask[:, None]
    pkey = jnp.where(ok, cells * _N_CODES + code[:, None], _I32_MAX).ravel()
    d_max = query.sides.shape[0]
    pdesc = jnp.broadcast_to(
        jnp.arange(d_max, dtype=jnp.int32)[:, None], (d_max, 27)
    ).ravel()
    order = jnp.argsort(pkey)
    return pkey[order], pdesc[order]


def extract_pairs_by_frame(
    db: DescriptorDB,
    query: Descriptors,
    pkeys: jnp.ndarray,
    pdesc: jnp.ndarray,
    cand_frames: jnp.ndarray,
    cand_valid: jnp.ndarray,
    search: SearchConfig,
    caps: CapacityConfig,
    row_offset: jnp.ndarray | None = None,
    pairs_cap: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pair pass: all matching (query-descriptor, DB-row) pairs per candidate
    frame (ref match_list assembly, STDesc.cpp:437-447), capped at
    ``pairs_cap`` per candidate.

    With ``row_offset`` set, only this shard's rows contribute (pair_row is
    then shard-local).
    """
    p_cap = pairs_cap if pairs_cap is not None else caps.pairs_per_candidate
    c_n = cand_frames.shape[0]
    r_max = caps.max_descriptors  # rows per keyframe bound
    pk_max = caps.probes_per_key
    m_rows = db.keys.shape[0]
    n_probes = pkeys.shape[0]

    # Candidate frames' rows are contiguous in the frame-major index.
    fs = db.frame_start[cand_frames]  # (C,)
    fe = db.frame_start[cand_frames + 1]
    pos = fs[:, None] + jnp.arange(r_max, dtype=jnp.int32)[None, :]  # (C, R)
    row_ok = (pos < fe[:, None]) & cand_valid[:, None]
    rows = db.frame_rows[jnp.clip(pos, 0, db.frame_rows.shape[0] - 1)]
    if row_offset is not None:
        rows_local = rows - row_offset
        row_ok = row_ok & (rows_local >= 0) & (rows_local < m_rows)
        rows = jnp.clip(rows_local, 0, m_rows - 1)
    rows = jnp.minimum(rows, m_rows - 1)

    rowkey = db.keys[rows]  # (C, R)
    w2 = db.packed2[rows]  # (C, R, 2)
    lo_w = w2[..., 0]
    hi_w = w2[..., 1]
    inv256 = jnp.float32(1.0 / 256.0)
    sa = (lo_w & 0xFFFF).astype(jnp.float32) * inv256
    sb = (lo_w >> 16).astype(jnp.float32) * inv256
    sc = (hi_w & 0xFFFF).astype(jnp.float32) * inv256

    # First probe with key >= rowkey (17 steps cover 55k probes).
    steps = max(int(np.ceil(np.log2(max(n_probes, 2)))) + 1, 1)
    lo0 = jnp.zeros_like(rowkey)
    hi0 = jnp.full_like(rowkey, n_probes)
    p_lo = _bisect(pkeys, rowkey, lo0, hi0, steps)

    thr2 = jnp.sum(query.sides * query.sides, axis=-1) * jnp.float32(
        search.rough_dis_threshold
    ) ** 2

    # pk_max separate gather passes over the probe table (a vmapped
    # dynamic_slice does not lower to a slice-sized gather).
    matches = []
    descs = []
    for j in range(pk_max):
        p = jnp.minimum(p_lo + j, n_probes - 1)
        key_eq = (pkeys[p] == rowkey) & (rowkey != _I32_MAX)
        qd = pdesc[p]  # (C, R)
        da = sa - query.sides[qd, 0]
        db_ = sb - query.sides[qd, 1]
        dc = sc - query.sides[qd, 2]
        dis2 = da * da + db_ * db_ + dc * dc
        matches.append(key_eq & row_ok & (dis2 < thr2[qd]))
        descs.append(qd)
    match = jnp.stack(matches, axis=-1)  # (C, R, K)
    qdesc = jnp.stack(descs, axis=-1)

    # Compact per candidate: rank matches along the flattened (row, probe)
    # axis, then ONE scatter of a packed 3-vector payload (qidx, row,
    # valid) — three separate scatters tripled the serialized update count
    # (819k updates each at the 2048-row frame bound; scatter cost is per
    # update, tools/scale_probe_prof.py).
    flat_m = match.reshape(c_n, -1)
    flat_d = qdesc.reshape(c_n, -1)
    flat_r = jnp.broadcast_to(rows[..., None], match.shape).reshape(c_n, -1)
    rank = jnp.cumsum(flat_m.astype(jnp.int32), axis=-1) - 1
    keep = flat_m & (rank < p_cap)
    ci = jnp.broadcast_to(
        jnp.arange(c_n, dtype=jnp.int32)[:, None], flat_m.shape
    )
    sc_c = jnp.where(keep, ci, c_n)
    sc_p = jnp.where(keep, rank, 0)
    payload = jnp.stack(
        [flat_d, flat_r, jnp.ones_like(flat_d)], axis=-1
    )  # (C, RK, 3)
    packed = (
        jnp.zeros((c_n + 1, p_cap, 3), jnp.int32)
        .at[sc_c, sc_p].set(payload)[:c_n]
    )
    return packed[..., 0], packed[..., 1], packed[..., 2] > 0


