"""The port's documentation generator against the JAX package's.

* The REST reference equals the JAX package's once the package name is
  rewritten.
* The config reference equals it row for row once the package name is
  rewritten (class-path defaults and the "Generated from" sentence), except
  the description of the six keys whose texts the port's copy of
  ``config/configs.py`` rewrote (``tests/test_torch_service_copies.py``
  names those regions), and three class-path defaults that the longer
  package name cuts at the reference's 60 characters in another place;
  every other column of those rows is equal.
* ``main`` writes both files into the directory it is given and has no
  default directory.
"""

from __future__ import annotations

import pytest

from ccx.tools import gen_docs as jax_gen_docs
from ccx_torch.tools import gen_docs

#: keys whose descriptions the port's ``config/configs.py`` rewrote: texts
#: that named TPU parts or times, a JAX mesh or its profiler, or the JAX
#: package's change history
REWORDED = {
    "optimizer.chunk.steps", "optimizer.mesh.enabled", "optimizer.polish.chunk.iters",
    "optimizer.plan.enabled", "optimizer.profile.dir", "observability.cost.peak.tflops",
}


def _unport(text: str) -> str:
    return text.replace("ccx_torch", "ccx")


def test_rest_reference_is_the_jax_packages():
    assert _unport(gen_docs.gen_rest_reference()) == jax_gen_docs.gen_rest_reference()


def test_config_reference_is_the_jax_packages_but_the_reworded_descriptions():
    ours = _unport(gen_docs.gen_config_reference()).splitlines()
    theirs = jax_gen_docs.gen_config_reference().splitlines()
    assert len(ours) == len(theirs)
    reworded, truncated = set(), set()
    for a, b in zip(ours, theirs):
        if a == b:
            continue
        (name, kind, default, importance, doc), theirs_cols = a.split(" | ", 4), b.split(" | ", 4)
        name = name.strip("| `")
        assert [name, kind, importance] == [theirs_cols[0].strip("| `"), theirs_cols[1],
                                            theirs_cols[3]]
        if default != theirs_cols[2]:
            # a class path under ``ccx_torch`` reaches the 60-character cut
            # sooner than the JAX package's: the same text, cut earlier
            assert default.endswith("...") and theirs_cols[2].startswith(default[:-3]), name
            truncated.add(name)
        if doc != theirs_cols[4]:
            reworded.add(name)
    assert reworded == REWORDED
    assert truncated == {"metric.sampler.class", "topic.anomaly.finder.class",
                         "replica.movement.strategies"}


@pytest.mark.parametrize("name,fn", [("Configurations.md", gen_docs.gen_config_reference),
                                     ("REST-API.md", gen_docs.gen_rest_reference)])
def test_main_writes_into_the_directory_it_is_given(name, fn, tmp_path, capsys):
    out = tmp_path / "wiki"
    assert gen_docs.main([str(out)]) == 0
    assert (out / name).read_text() == fn()
    assert str(out) in capsys.readouterr().out


def test_main_without_an_output_directory_exits_non_zero():
    with pytest.raises(SystemExit) as exc:
        gen_docs.main([])
    assert exc.value.code != 0
