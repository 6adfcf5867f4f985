"""Print the fully resolved config (reference tools/misc/print_config.py;
port of ``tools/print_config.py``).

Resolves ``_base_`` inheritance and ``--cfg-options`` overrides through the
loader every CLI of the port uses (``occformer_tpu_torch/config.py``), so
what prints is what train and test consume.

Usage:
  python3 -m occformer_tpu_torch.tools.print_config <config>
      [--cfg-options a.b=value ...] [--json]
"""
from __future__ import annotations

import argparse
import json
import pprint

from ..config import load_config, parse_cfg_options


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--json", action="store_true", help="JSON instead of pprint")
    args = p.parse_args(argv)
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    if args.json:
        print(json.dumps(cfg, indent=1, default=repr))
    else:
        pprint.pprint(cfg, width=100, sort_dicts=False)


if __name__ == "__main__":
    main()
