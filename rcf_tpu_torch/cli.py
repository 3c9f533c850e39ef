"""Command-line entry point of the port (port of ``rcf_tpu/cli.py``).

    python -m rcf_tpu_torch.cli <config.yaml> [--test]
        [--test-override-pretrained PATH]
        [--test-override-object-channel N]
        [--no-test] [--print-config]
        [--opts KEY VALUE ...]

Runs on the CUDA card (``train/loop.py::run``) and raises without one;
``--print-config`` needs no card and prints the resolved config as block
YAML (``yaml_subset.dump``).

On several cards, one process a card, as the JAX package is launched:
``RCF_COORDINATOR=host:port RCF_NUM_PROCESSES=N RCF_PROCESS_ID=i
RCF_LOCAL_DEVICE_IDS=<card>``, or ``RCF_DIST=1`` under a launcher that
sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``
(``torchrun --nproc-per-node N -m rcf_tpu_torch.cli ...`` with
``RCF_DIST=1``). The process group (NCCL) is joined before anything
touches the card and left at exit.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import yaml_subset
from .config import load_config
from .parallel import dist
from .utils import get_logger, set_loglevel

logger = get_logger()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="RCF on CUDA cards: unsupervised video "
                                                 "segmentation")
    parser.add_argument("config", type=str, nargs="?", default="configs/rcf/rcf_stage1.yaml",
                        help="path to YAML config")
    parser.add_argument("--test", action="store_true", help="evaluation only")
    parser.add_argument("--test-override-pretrained", type=str, default=None,
                        help="override pretrained checkpoint at test time")
    parser.add_argument("--test-override-object-channel", type=int, default=None,
                        help="override object channel at test time")
    parser.add_argument("--no-test", action="store_true",
                        help="skip the final test after training")
    parser.add_argument("--print-config", action="store_true",
                        help="print the resolved config and exit")
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                        help="dotted KEY VALUE config overrides")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns 0 for ``--print-config``, else what ``run`` returns (the test's
    ``EvalResult``, or the train state with ``--no-test``)."""
    cli = parse_args(argv)
    set_loglevel(debug=True)
    logger.info(f"Loading config from {cli.config}")
    cfg = load_config(cli.config, opts=cli.opts)

    if cli.test:
        if cli.test_override_pretrained is not None:
            cfg.pretrained_model = cli.test_override_pretrained
            cfg.checkpoints_dir = os.path.dirname(cli.test_override_pretrained)
        if cli.test_override_object_channel is not None:
            cfg.object_channel = cli.test_override_object_channel

    if cli.print_config:
        sys.stdout.write(yaml_subset.dump(cfg.to_dict()))
        return 0

    from .train.loop import run

    join = dist.requested() and not dist.joined()
    if join:
        dist.init_distributed(device="cuda")
    try:
        return run(cfg, test_only=cli.test, no_test=cli.no_test)
    finally:
        if join:
            dist.shutdown()


if __name__ == "__main__":
    main()
    raise SystemExit(0)
