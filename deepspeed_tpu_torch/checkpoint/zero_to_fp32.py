"""A float32 state dict from a checkpoint of the port (counterpart of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``, after the reference's
``deepspeed/utils/zero_to_fp32.py``).

A port checkpoint holds every master whole in the universal layout, so
consolidation is a read of the ``fp32`` leaves: no shard merging. Offered
as an API and a command line.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from .ds_to_universal import load_universal
from .universal.layout import param_name


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, torch.Tensor]:
    """The masters of ``checkpoint_dir/tag`` (default: the ``latest``
    file's tag) as float32 CPU tensors under the port's dotted parameter
    names, ready for ``CausalLM.load_state_dict``."""
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest):
            raise ValueError(f"no 'latest' file in {checkpoint_dir}; pass tag")
        with open(latest) as f:
            tag = f.read().strip()
    flat = load_universal(os.path.join(checkpoint_dir, str(tag)))
    return {param_name(name): t.float() for name, t in flat.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None
                                               ) -> None:
    """Write the consolidated state dict to ``output_file`` with
    ``torch.save``."""
    torch.save(get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag),
               output_file)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("-t", "--tag", default=None)
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, args.tag)
    print(f"saved fp32 state dict to {args.output_file}")


if __name__ == "__main__":
    main()
