"""Remat in the port's train step for the xLSTM family, unsharded and with
the sequence-parallel mLSTM on an 8-entry CPU mesh, held as
tests/test_torch_remat.py holds the others (that file states the
contract and the tolerances): the loss and every gradient under remat
"none", "dots" and "full" equal bit for bit, and each within GRAD_RTOL of
the reference's `make_loss_fn` under the same remat."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_remat import check_remat_case  # noqa: E402

CASES = [("xlstm", "xlstm-350m", None),
         ("xlstm-seqpar", "xlstm-350m", dict(ssm_impl="seqpar"))]


@pytest.mark.parametrize("case,arch,sharded", CASES,
                         ids=[c[0] for c in CASES])
def test_remat_gradients_equal_none_and_the_reference(case, arch, sharded,
                                                      monkeypatch):
    check_remat_case(arch, sharded, monkeypatch)
