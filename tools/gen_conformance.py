"""Generate docs/CONFORMANCE.md from the pinned oracle.

The float64 oracle (`cpu_ref/oracle.py`) is the numerics contract for the
whole framework (its module docstring pins every structural convention).
This tool renders that contract plus each public oracle function's
docstring into a single reviewable document, so the conventions are
readable without spelunking the source and drift between code and doc is
a one-command regeneration away:

    python tools/gen_conformance.py          # rewrite docs/CONFORMANCE.md
    python tools/gen_conformance.py --check  # exit 1 if the doc is stale
"""

from __future__ import annotations

import argparse
import inspect
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HEADER = """\
# Numerics conformance contract

GENERATED by `tools/gen_conformance.py` — edit the docstrings in
`audiosignalprocess_tpu/cpu_ref/oracle.py`, not this file.

Every compute path in the framework (jnp ops, sharded bodies, streaming
stages) must match the float64 oracle bit-for-bit in structure (lengths,
framing, ordering, scaling) and >= 60 dB SNR numerically; the native C
oracle (`native/asp_ref.c`) is cross-checked against it to 1e-9
(`tests/unit/test_native_oracle.py`).  On-GPU enforcement: `chip_smoke.py`
(exit nonzero below 60 dB).
"""


def render() -> str:
    from audiosignalprocess_tpu.cpu_ref import oracle

    out = [HEADER]
    out.append("## Pinned conventions (oracle module docstring)\n")
    mod_doc = inspect.getdoc(oracle) or ""
    out.append(mod_doc.strip() + "\n")
    out.append("## Per-function contracts\n")
    names = [n for n, f in vars(oracle).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == oracle.__name__]
    for name in names:
        fn = getattr(oracle, name)
        sig = str(inspect.signature(fn))
        doc = inspect.getdoc(fn) or "(no docstring)"
        _, line = inspect.getsourcelines(fn)
        out.append(f"### `{name}{sig}`\n")
        out.append(f"`cpu_ref/oracle.py:{line}`\n")
        out.append(textwrap.indent(doc.strip(), "") + "\n")
    return "\n".join(out)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true",
                   help="exit 1 if docs/CONFORMANCE.md is out of date")
    args = p.parse_args()
    target = REPO / "docs" / "CONFORMANCE.md"
    text = render()
    if args.check:
        if not target.exists() or target.read_text() != text:
            print("docs/CONFORMANCE.md is stale; run tools/gen_conformance.py")
            return 1
        print("docs/CONFORMANCE.md is up to date")
        return 0
    target.write_text(text)
    print(f"wrote {target} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
