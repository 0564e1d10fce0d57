"""Map server CLI: the `server_node` executable analog (src/ros_server.cc:
201-210).

Port of the JAX package's `server_node.py`. It accepts SLAM-client
connections, mirrors their maps, reports per-client statistics every few
seconds and serves merged-map requests:

  python -m orb_slam2v2_1_tpu_torch.server_node --port 7007 [--max-kf 256] [--cpu]

Operator commands (the ServerViewer menu, src/ServerViewer.cc:56-139):

  python -m orb_slam2v2_1_tpu_torch.server_node ctl --port 7007 list
  python -m orb_slam2v2_1_tpu_torch.server_node ctl --port 7007 save --cid 1 --path m.npz
  python -m orb_slam2v2_1_tpu_torch.server_node ctl --port 7007 load --cid 1 --path m.npz
  python -m orb_slam2v2_1_tpu_torch.server_node ctl --port 7007 reset --cid 1
  python -m orb_slam2v2_1_tpu_torch.server_node ctl --port 7007 send --cid 1 --merge-with 2

The reference pins its server to the host's CPU. The port follows its own
device rule instead: the clients' maps and the merge (BoW ranking, Sim3,
essential graph, fusion) live on the NVIDIA card, the server raises when
there is none, and `--cpu` asks for the CPU. `ctl` touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _ctl(argv):
    p = argparse.ArgumentParser(prog="server_node ctl", description="map server operator commands")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7007)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    for name in ("reset", "save", "load", "send"):
        sp = sub.add_parser(name)
        sp.add_argument("--cid", type=int, required=True)
        if name in ("save", "load"):
            sp.add_argument("--path", required=True)
        if name == "send":
            sp.add_argument("--merge-with", type=int, default=None)
    args = p.parse_args(argv)

    from .parallel.stream import OperatorClient

    op = OperatorClient(args.host, args.port)
    try:
        if args.cmd == "list":
            out = op.list_clients()
        elif args.cmd == "reset":
            out = op.reset(args.cid)
        elif args.cmd == "save":
            out = op.save(args.cid, args.path)
        elif args.cmd == "load":
            out = op.load(args.cid, args.path)
        else:
            out = op.send_merge(args.cid, args.merge_with)
    finally:
        op.close()
    print(json.dumps(out))
    return 0 if out.get("ok") else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "ctl":
        return _ctl(argv[1:])
    p = argparse.ArgumentParser(description="ORB-SLAM multi-session map server (PyTorch)")
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--max-kf", type=int, default=256)
    p.add_argument("--max-mp", type=int, default=32768)
    p.add_argument("--n-kp", type=int, default=1024)
    p.add_argument("--report-s", type=float, default=5.0)
    p.add_argument("--save-dir", default=None, help="directory for periodic per-client map snapshots")
    p.add_argument("--cpu", action="store_true", help="keep the maps on the CPU (default: the NVIDIA card)")
    args = p.parse_args(argv)

    import torch

    from . import sync
    from .parallel.stream import MapServerNode

    node = MapServerNode(args.port, args.max_kf, args.max_mp, args.n_kp, device="cpu" if args.cpu else None)
    print(f"map server listening on :{node.port} ({node.device})", flush=True)
    try:
        while True:
            time.sleep(args.report_s)
            for cid, cm in sorted(node.server.clients.items()):
                st = cm.state
                n_kf, n_mp = sync.host(torch.stack([st.n_kf, torch.sum(st.mp_valid, dtype=torch.int32)]))
                print(f"client {cid}: kf={n_kf} mp={n_mp} deltas={cm.n_deltas}", flush=True)
            if args.save_dir:
                from pathlib import Path

                from .utils import serialization

                out = Path(args.save_dir)
                out.mkdir(parents=True, exist_ok=True)
                for cid, cm in list(node.server.clients.items()):
                    serialization.save_map(cm.state, out / f"client_{cid}.npz")
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
