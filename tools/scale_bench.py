"""Large-map scale run: build and query a multi-million-row descriptor DB.

The 20k-keyframe capacity the config advertises (caps.max_frames; the
reference's MAX_FRAME_N=20000 vote-array ceiling, STDesc.h:33) exercised
end to end: a synthetic world at thousands of keyframes, the DB assembled
on device, query latency measured with the usual accuracy gates (revisit
queries must localize, no probe-scan truncation). GPU only.

    python tools/scale_bench.py [num_map_frames]      # default 5000

Set SCALE_SEL=1 / SCALE_SEL=0 to force the sel / candidate-major pair
extraction regardless of config.caps.sel_max_scan_slots.
"""

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from sgtd_tpu import SGTDConfig
    from sgtd_tpu.eval.benchworld import build_index, make_scale_graphs
    from sgtd_tpu.eval.metrics import rpe
    from sgtd_tpu.match.pipeline import localize
    from sgtd_tpu.match.search import TRUNC_SCAN
    from sgtd_tpu.utils.compile_cache import enable_compile_cache
    from sgtd_tpu.utils.device import card_line, require_gpu

    enable_compile_cache()
    dev = require_gpu()
    print(f"[scale] {dev.device_kind} | card: {card_line()}", file=sys.stderr)

    num_map = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    num_q = 32
    cfg = SGTDConfig()
    t0 = time.time()
    maps, queries, _ = make_scale_graphs(num_map, num_q, cfg)
    print(f"[scale] world+graphs: {time.time()-t0:.1f}s ({num_map} keyframes)",
          file=sys.stderr)

    # Deep buckets at scale need a bigger ragged-scan budget than the bench
    # default; calibration only lowers it, so raise it before building.
    sel = os.environ.get("SCALE_SEL", "")
    sel_max = {"1": 1 << 30, "0": 0}.get(sel, cfg.caps.sel_max_scan_slots)
    cfg = cfg.replace(caps=dataclasses.replace(
        cfg.caps, max_scan_slots=1 << 23, sel_max_scan_slots=sel_max))
    t0 = time.time()
    cfg, db, qb, _, report = build_index(maps, queries, cfg)
    jax.block_until_ready(db.keys)
    build_s = time.time() - t0
    print(f"[scale] DB build: {build_s:.1f}s rows={report.num_rows} "
          f"scan_slots={cfg.caps.max_scan_slots}", file=sys.stderr)

    # 8-query chunks bound the (batch, L) ragged-scan workspace.
    chunk = 8
    loc_fn = jax.jit(
        jax.vmap(functools.partial(localize, config=cfg), in_axes=(None, 0))
    )
    chunks = [jax.tree_util.tree_map(lambda x: x[i:i + chunk], qb)
              for i in range(0, num_q, chunk)]
    t0 = time.time()
    jax.block_until_ready(loc_fn(db, chunks[0]))
    print(f"[scale] compile+first chunk: {time.time()-t0:.1f}s", file=sys.stderr)

    reps = 2
    t0 = time.time()
    for _ in range(reps):
        outs = [loc_fn(db, c) for c in chunks]
        jax.block_until_ready(outs)
    per_query_ms = (time.time() - t0) / (reps * num_q) * 1000.0
    res = jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *outs
    )

    n_trunc = int(np.sum((res.truncated & TRUNC_SCAN) != 0))
    n_succ = 0
    for i, g in enumerate(queries):
        if res.found[i]:
            t_err, r_err = rpe(np.asarray(g.pose), res.poses[i, 0])
            n_succ += (t_err < cfg.success_trans_m) & (r_err < cfg.success_rot_deg)
    sr = n_succ / num_q
    print(json.dumps({
        "device": dev.device_kind,
        "keyframes": num_map,
        "db_rows": report.num_rows,
        "db_build_s": build_s,
        "query_ms_pipelined": per_query_ms,
        "sr": sr,
        "scan_slots": cfg.caps.max_scan_slots,
        "truncated_queries": n_trunc,
        "num_queries": num_q,
    }))
    if sr < 0.9 or n_trunc:
        print(f"[scale] FAIL: SR={sr:.3f}, {n_trunc} truncated probe scans",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
