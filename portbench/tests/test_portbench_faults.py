"""The rest of a run, past the look for a card, on the CPU at tiny size: a
sound run comes out correct, and each fault a cell can have, planted under
the timed path, comes out not correct (the one-card cells have no exchange
between chips to leave out)."""
import pytest

from portbench.tests import faults, tiny


@pytest.fixture(scope="module", params=["per_row", "per_group"])
def root(request, tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp(request.param), request.param)


def test_sound_run_is_correct(root):
    line, stderr = tiny.run(*root)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert "mean_logit_gap" in stderr


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(root, fault):
    with faults.FAULTS[fault]():
        line, _ = tiny.run(*root)
    assert not line["correct"], (fault, line["checks"])
