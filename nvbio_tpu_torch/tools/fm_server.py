"""Persistent index server (nvFM-server equivalent, device-resident).

Port of ``nvbio_tpu/tools/fm_server.py``: one process loads an index
once, keeps it and its mappers warm on ``--device``, and serves mapping
jobs over a unix socket, so that each ``map`` request pays only the
per-batch work.  Warm means: the index and the single-end mapper's
genome and packed words are on the device, the kernel library
(``ops/_build.py``) is loaded, and the card is synchronised; the
``attach_seconds`` every reply carries covers all of it.  The paired-end
mapper is made at the first paired request, as in the reference.  An
unsharded ``.npz`` is served by ``Mapper``/``PairedMapper``, a sharded
index (its prefix or ``.manifest.json``) by ``ShardedMapper``/
``PairedShardedMapper``, with ``MapperParams`` at their defaults but for
the batch, the read length and the index's sampling.

    # daemon (holds the index on the device until `stop`):
    python -m nvbio_tpu_torch.tools.fm_server serve -x idx.npz \\
        --socket /tmp/fm.sock [--device cuda|cpu]

    # clients (return when the SAM is written):
    python -m nvbio_tpu_torch.tools.fm_server map --socket /tmp/fm.sock \\
        -U reads.fq -S out.sam
    python -m nvbio_tpu_torch.tools.fm_server map --socket /tmp/fm.sock \\
        -1 r1.fq -2 r2.fq -S out.sam
    python -m nvbio_tpu_torch.tools.fm_server ping --socket /tmp/fm.sock
    python -m nvbio_tpu_torch.tools.fm_server stop --socket /tmp/fm.sock

The protocol is the reference's: one JSON object a line each way.
``publish`` copies an index file into /dev/shm for host page-cache
sharing (``list``, ``remove``), as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time

SHM_DIR = "/dev/shm/nvbio_tpu_torch"
# the default socket, in the temporary directory (TMPDIR where set)
SOCKET = os.path.join(tempfile.gettempdir(), "nvbio_torch_fm.sock")


def publish(path):
    os.makedirs(SHM_DIR, exist_ok=True)
    dst = os.path.join(SHM_DIR, os.path.basename(path))
    shutil.copyfile(path, dst)
    print(dst)
    return 0


# ---------------------------------------------------------------- daemon

def _recv_json(conn):
    buf = b""
    while not buf.endswith(b"\n"):
        chunk = conn.recv(1 << 16)
        if not chunk:
            return None
        buf += chunk
    return json.loads(buf.decode())


def _send_json(conn, obj):
    conn.sendall((json.dumps(obj) + "\n").encode())


def _handle_map(state, req):
    """Run one mapping job with the resident mapper."""
    from ..io.fastq import FastqBatchReader
    from ..io.sam import SamWriter
    from ..io.sequence import ReadBatchIterator
    from ..strings.string_set import pack_reads

    mapper = state["pe_mapper" if req.get("m1") else "se_mapper"]()
    meta = state["meta"]
    batch = int(req.get("batch", state["batch"]))
    max_len = int(req.get("max_read_len", state["max_read_len"]))
    sam = req["sam"]
    writer_cls = SamWriter
    if sam.endswith(".bam"):
        from ..io.bam import BamWriter as writer_cls
    writer = writer_cls(sam, meta["contig_names"], meta["contig_lens"],
                        cmdline=f"fm_server map {req}")
    t0 = time.time()
    n = n_aligned = 0
    if req.get("m1"):
        def pairs():
            it1 = FastqBatchReader(req["m1"], batch)
            it2 = FastqBatchReader(req["m2"], batch)
            for (n1, s1, q1), (n2, s2, q2) in zip(it1, it2):
                r1, l1, qm1, _ = pack_reads(s1, q1, max_len=max_len)
                r2, l2, qm2, _ = pack_reads(s2, q2, max_len=max_len)
                yield n1, r1, l1, qm1, r2, l2, qm2

        for (n1, r1, l1, qm1, r2, l2, qm2, res1, res2,
             info) in mapper.map_pairs_stream(pairs()):
            n += len(res1) + len(res2)
            n_aligned += sum(r.aligned for r in res1)
            n_aligned += sum(r.aligned for r in res2)
            for rec in mapper.to_sam_records_pe(
                    n1, r1, l1, qm1, r2, l2, qm2, res1, res2, info):
                writer.write(rec)
    else:
        def batches():
            for names, seqs, quals in ReadBatchIterator(req["u"], batch):
                reads, lens, qmat, _ = pack_reads(seqs, quals,
                                                  max_len=max_len)
                yield names, reads, lens, qmat

        for names, reads, lens, qmat, results in \
                mapper.map_stream(batches()):
            n += len(results)
            n_aligned += sum(r.aligned for r in results)
            for rec in mapper.to_sam_records(names, reads, lens, qmat,
                                             results):
                writer.write(rec)
    writer.close()
    dt = time.time() - t0
    return {"status": "ok", "reads": n, "aligned": n_aligned,
            "seconds": round(dt, 3),
            "reads_per_sec": round(n / max(dt, 1e-9), 1),
            "attach_seconds": state["attach_seconds"]}


def serve(index_path, sock_path, batch=4096, max_read_len=320,
          device="cuda", once=False):
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..io.index_file import load_index
    from ..models import Mapper, MapperParams
    from ..models.paired import PairedMapper

    dev = resolve_device(device)
    t0 = time.time()
    prefix = index_path
    for suf in (".npz", ".manifest.json"):
        if prefix.endswith(suf):
            prefix = prefix[: -len(suf)]
    sharded = os.path.exists(prefix + ".manifest.json") and not (
        index_path.endswith(".npz") and os.path.exists(index_path))
    if sharded:
        from ..fmindex.sharded import load_sharded_index

        sidx, genome, man = load_sharded_index(prefix, device=dev)
        meta = {"sa_sample": man["sa_sample"], "lut_k": man["lut_k"],
                "contig_names": man["contig_names"],
                "contig_lens": man["contig_lens"]}
        fm = ssa = None
    else:
        fm, ssa, genome, meta = load_index(index_path, device=dev)
    params = MapperParams(batch_size=batch, sa_sample=meta["sa_sample"],
                          lut_k=meta.get("lut_k", 0),
                          max_read_len=max_read_len)
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    genome = genome.astype(np.uint8)
    state = {
        "meta": meta, "batch": batch, "max_read_len": max_read_len,
        "attach_seconds": None,
    }
    mappers = {}

    def get_mapper(cls):
        if sharded:
            from ..models.sharded_mapper import (PairedShardedMapper,
                                                 ShardedMapper)

            cls = (PairedShardedMapper if cls is PairedMapper
                   else ShardedMapper)
            if cls not in mappers:
                mappers[cls] = cls(sidx, genome, params=params,
                                   contigs=contigs)
        elif cls not in mappers:
            mappers[cls] = cls(fm, ssa, genome, params=params,
                               contigs=contigs, lut=meta.get("lut"))
        return mappers[cls]

    # warm: the SE mapper's device state now, the kernel library loaded,
    # the card idle (the cold start the daemon exists to hide)
    get_mapper(Mapper)
    if dev.type == "cuda":
        from ..ops import _build

        _build.library()
        torch.cuda.synchronize(dev)
    state["se_mapper"] = lambda: get_mapper(Mapper)
    state["pe_mapper"] = lambda: get_mapper(PairedMapper)
    state["attach_seconds"] = round(time.time() - t0, 3)

    if os.path.exists(sock_path):
        os.remove(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    # the socket appears at sock_path only once it listens: a client that
    # sees the path never meets a refused connection
    tmp = f"{sock_path}.{os.getpid()}"
    srv.bind(tmp)
    srv.listen(4)
    os.replace(tmp, sock_path)
    print(f"[fm_server] serving {index_path} on {sock_path} from {dev} "
          f"(attach {state['attach_seconds']}s)", file=sys.stderr,
          flush=True)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                req = _recv_json(conn)
                if req is None:
                    continue
                if req.get("cmd") == "stop":
                    _send_json(conn, {"status": "stopped"})
                    break
                if req.get("cmd") == "ping":
                    _send_json(conn, {
                        "status": "ok",
                        "attach_seconds": state["attach_seconds"],
                        "index": index_path, "device": str(dev)})
                    continue
                if req.get("cmd") == "map":
                    try:
                        _send_json(conn, _handle_map(state, req))
                    except Exception as e:  # job error: keep serving
                        _send_json(conn, {"status": "error",
                                          "error": repr(e)})
                    if once:
                        break
                    continue
                _send_json(conn, {"status": "error",
                                  "error": "unknown cmd"})
            finally:
                conn.close()
    finally:
        srv.close()
        if os.path.exists(sock_path):
            os.remove(sock_path)
    return 0


def request(sock_path, obj, timeout=3600):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(sock_path)
    _send_json(c, obj)
    resp = _recv_json(c)
    c.close()
    return resp


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="fm_server", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("serve")
    ps.add_argument("-x", "--index", required=True)
    ps.add_argument("--socket", default=SOCKET)
    ps.add_argument("--batch", type=int, default=4096)
    ps.add_argument("--max-read-len", type=int, default=320)
    ps.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never picked implicitly")
    pm = sub.add_parser("map")
    pm.add_argument("--socket", default=SOCKET)
    pm.add_argument("-U", dest="u")
    pm.add_argument("-1", dest="m1")
    pm.add_argument("-2", dest="m2")
    pm.add_argument("-S", dest="sam", required=True)
    pm.add_argument("--batch", type=int)
    for name in ("ping", "stop"):
        px = sub.add_parser(name)
        px.add_argument("--socket", default=SOCKET)
    pp = sub.add_parser("publish")
    pp.add_argument("index")
    sub.add_parser("list")
    pr = sub.add_parser("remove")
    pr.add_argument("name")
    args = p.parse_args(argv)

    if args.cmd == "serve":
        return serve(args.index, args.socket, batch=args.batch,
                     max_read_len=args.max_read_len, device=args.device)
    if args.cmd == "map":
        req = {"cmd": "map", "sam": args.sam}
        if args.u:
            req["u"] = args.u
        if args.m1:
            req["m1"], req["m2"] = args.m1, args.m2
        if args.batch:
            req["batch"] = args.batch
        resp = request(args.socket, req)
        print(json.dumps(resp))
        return 0 if resp and resp.get("status") == "ok" else 1
    if args.cmd in ("ping", "stop"):
        resp = request(args.socket, {"cmd": args.cmd}, timeout=60)
        print(json.dumps(resp))
        return 0
    if args.cmd == "publish":
        return publish(args.index)
    if args.cmd == "list":
        if os.path.isdir(SHM_DIR):
            for f in sorted(os.listdir(SHM_DIR)):
                print(os.path.join(SHM_DIR, f))
        return 0
    if args.cmd == "remove":
        os.remove(os.path.join(SHM_DIR, args.name))
        return 0


if __name__ == "__main__":
    sys.exit(main())
