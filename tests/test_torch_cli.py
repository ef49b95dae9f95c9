"""The port's option parser mirrors the JAX package's option by option
(ROADMAP Queue 1 item 5): the same destinations, option strings,
defaults, choices, nargs, constants, types, metavars and actions, with
--device the port's only addition.  --jax-profile-dir keeps the
reference's name; its help says it writes a torch.profiler trace
(tests/test_torch_import.py runs it)."""

import argparse

from sina_tpu import cli as jax_cli
from sina_tpu_torch import cli as torch_cli

FIELDS = ("option_strings", "default", "choices", "nargs", "const", "type",
          "required", "metavar")


def _actions(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in parser._actions}


def test_port_adds_only_device():
    ref = _actions(jax_cli.build_parser())
    port = _actions(torch_cli.build_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert port["device"].default == "cuda"


def test_every_option_matches_reference():
    ref = _actions(jax_cli.build_parser())
    port = _actions(torch_cli.build_parser())
    diffs = [(dest, "action", type(a).__name__, type(port[dest]).__name__)
             for dest, a in ref.items() if type(port[dest]) is not type(a)]
    diffs += [(dest, f, getattr(a, f), getattr(port[dest], f))
              for dest, a in ref.items() for f in FIELDS
              if getattr(port[dest], f) != getattr(a, f)]
    assert not diffs


def test_jax_profile_dir_help_names_torch_profiler():
    port = _actions(torch_cli.build_parser())["jax_profile_dir"]
    assert "torch.profiler" in port.help
