"""CLI: ``python -m rafiki_tpu_torch <command>``.

The port's own copy of ``rafiki_tpu/__main__.py``: the whole control
plane is one process, so the CLI is the deployment surface:

  python -m rafiki_tpu_torch serve [--host H] [--port P] [--device cuda|cpu]
  python -m rafiki_tpu_torch version

``serve`` runs the admin REST server; jobs train and serve on the CUDA
card unless ``--device cpu`` is given. The benchmark command is not
ported yet.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rafiki_tpu_torch")
    sub = parser.add_subparsers(dest="command")

    serve_p = sub.add_parser("serve", help="run the admin server")
    serve_p.add_argument("--host", default=None)
    serve_p.add_argument("--port", type=int, default=None)
    serve_p.add_argument("--device", default=None,
                         help="cuda (the default) or cpu")

    sub.add_parser("version", help="print version")

    args = parser.parse_args(argv)
    if args.command == "serve":
        from rafiki_tpu_torch.admin.app import serve

        try:
            serve(host=args.host, port=args.port, device=args.device)
        except KeyboardInterrupt:
            pass
        return 0
    if args.command == "version":
        import rafiki_tpu_torch

        print(rafiki_tpu_torch.__version__)
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
