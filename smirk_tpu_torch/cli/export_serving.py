"""Export the inference step as a serving artifact (`torch.export`; the
twin of tools/export_serving.py):

  python -m smirk_tpu_torch.cli.export_serving --out artifacts/smirk_b8 \\
      --batch 8 [--checkpoint pretrained_models/SMIRK_em1.pt] \\
      [--devices N] [--reconstruct] [--device cpu]

Weights are in the artifact; the serving host needs torch and the port's op
module (smirk_tpu_torch.serving.load_inference). The artifact runs on the
platform it was exported on: the CUDA card unless --device cpu.
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--devices", type=int, default=1,
                   help="split the batch over N replicas, one a device "
                        "(multi-device serving artifact)")
    p.add_argument("--reconstruct", action="store_true",
                   help="export the full analysis-by-neural-synthesis "
                        "reconstruction (render + hints + hull mask + fuse "
                        "generator) instead of the params/render step; "
                        "inputs become (img, hull, the draws)")
    p.add_argument("--device", default=None,
                   help="export on this device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.reconstruct and args.devices > 1:
        p.error("--reconstruct is single-device (shard by running one "
                "artifact per card; the batch axis is embarrassingly "
                "parallel)")

    from smirk_tpu_torch import serving
    from smirk_tpu_torch.cli.demo import build_system

    system = build_system(args.checkpoint, use_generator=args.reconstruct,
                          device=args.device)
    if args.reconstruct:
        path = serving.export_reconstruct(system, args.out, batch_size=args.batch)
    elif args.devices > 1:
        path = serving.export_inference_sharded(system, args.out, batch_size=args.batch,
                                                n_devices=args.devices)
    else:
        path = serving.export_inference(system, args.out, batch_size=args.batch)
    print("wrote", path, "and", path + serving.META_SUFFIX)
    return 0


if __name__ == "__main__":
    sys.exit(main())
