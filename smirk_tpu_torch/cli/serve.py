"""Serving daemon CLI: host an exported artifact over HTTP (the twin of
tools/serve.py). Pair with smirk_tpu_torch.cli.export_serving:

  python -m smirk_tpu_torch.cli.export_serving --out art --batch 64
  python -m smirk_tpu_torch.cli.serve art --port 8000

  curl http://host:8000/healthz
  curl http://host:8000/meta
  POST /predict: npz body {img: (N,H,W,3) float32 [0,1]} -> npz of outputs
  (any N: requests are bucketed to the exported batch size)
"""
import argparse
import sys


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("artifact", help="path to the .pt2 artifact")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from smirk_tpu_torch.serving import create_http_server

    srv = create_http_server(args.artifact, args.host, args.port)
    b = srv.inference.batch
    print(f"serving {args.artifact} (batch {b}) on "
          f"http://{args.host}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
