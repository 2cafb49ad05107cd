"""``tools/compare_trees.py`` on the CPU: each mode's timing script (run on
the card, in this checkout and in another one) is valid Python, and the
command line refuses a mode it does not have."""

import ast

import pytest

from nextgen_uia_tpu_torch.tools import compare_trees


@pytest.mark.parametrize("mode", sorted(compare_trees.TIMINGS))
def test_timing_scripts_parse(mode):
    script, tag = compare_trees.TIMINGS[mode]
    ast.parse(script)
    assert tag.strip() in script


def test_unknown_mode_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="usage"):
        compare_trees.main([str(tmp_path), "k99"])
