"""``python -m torchpruner_tpu_torch <command>`` — the port's CLI.

Commands in this slice:

    serve <preset> [--smoke] [--cpu] --synthetic N [--verify] ...
        the continuous-batching engine on synthetic traffic
        (torchpruner_tpu_torch/serve/frontend.py)
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from torchpruner_tpu_torch.serve.frontend import serve_main

        return serve_main(argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
