"""patch_ms.<entry>: device busy ms per unit of work in the program's
``s2v.patch_embed`` (the video's and the subject's patch embedding, the
subject's repeat into a temporal patch) and ``s2v.unpatchify`` spans
(``proj_out`` and the unpatchify), from the spans' CUDA events less the
window's idle inside them (``benchmark/spans.py``); None where the program
has neither span."""

from benchmark import spans


def read(run):
    found = [ms for ms in (spans.device_ms_per_unit(run, name) for name in ("s2v.patch_embed", "s2v.unpatchify"))
             if ms is not None]
    return sum(found) if found else None
