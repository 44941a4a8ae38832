"""Text at automerge-perf scale on the port, on the CPU: the cases of
tests/test_text_scale.py under their names. One text doc, one author,
one op per change (the automerge-perf trace's shape) through the port's
`run_batch(device="cpu")` (the plain version of the doc kernel):

- at 16k ops (tier-1) its every output lane equals the host numpy twin
  (`run_batch_host`) and the JAX package's `run_batch` on the same
  changes; at 128k ops (the int32 wide-lane bucket) against the host
  twin behind `-m slow`, as in the reference;
- the text it decodes equals the host OpSet's char for char at 4k ops
  (tier-1) and 8k ops (`-m slow`; the OpSet replay is quadratic in the
  doc's length).

Tolerance: exact.
"""

import numpy as np
import pytest

from hypermerge_tpu_torch.crdt.change import Action
from hypermerge_tpu_torch.crdt.opset import OpSet
from hypermerge_tpu_torch.models import Text
from hypermerge_tpu_torch.ops.columnar import pack_docs
from hypermerge_tpu_torch.ops.materialize import materialize_batch, text_join
from hypermerge_tpu_torch.ops.synth import synth_changes


def _trace_shaped(n_ops: int, seed: int = 3):
    """automerge-perf trace shape: one author, one op per change, all
    text edits."""
    return synth_changes(
        n_ops, n_actors=1, ops_per_change=1, text_frac=1.0, seed=seed
    )


def _device_text(dec, d: int = 0) -> str:
    c = dec.cols
    n = int(dec.batch.n_ops[d])
    text_rows = np.nonzero(
        c["action"][d][:n] == int(Action.MAKE_TEXT)
    )[0]
    assert len(text_rows) == 1, len(text_rows)
    return text_join(dec, d, int(text_rows[0]))


def _lanes(out):
    return {f: np.asarray(getattr(out, f).cpu() if hasattr(
        getattr(out, f), "cpu") else getattr(out, f)) for f in out._fields}


def _assert_device_matches_host_twin(n_ops: int, reference: bool) -> None:
    from hypermerge_tpu_torch.ops.crdt_kernels import run_batch
    from hypermerge_tpu_torch.ops.host_kernel import run_batch_host

    changes = _trace_shaped(n_ops)
    batch = pack_docs([changes])
    dev = _lanes(run_batch(batch, device="cpu"))
    host = run_batch_host(batch)
    for f in host._fields:
        np.testing.assert_array_equal(dev[f], getattr(host, f), err_msg=f)
    if reference:
        from hypermerge_tpu.ops.columnar import pack_docs as ref_pack
        from hypermerge_tpu.ops.crdt_kernels import run_batch as ref_run
        from hypermerge_tpu.ops.synth import synth_changes as ref_synth

        ref = ref_run(ref_pack([ref_synth(
            n_ops, n_actors=1, ops_per_change=1, text_frac=1.0, seed=3)]))
        assert set(ref._fields) == set(dev)
        for f in ref._fields:
            np.testing.assert_array_equal(
                dev[f], np.asarray(getattr(ref, f)), err_msg=f)


def test_text_16k_device_matches_host_twin():
    # 16_384 rows: the largest bucket on the int16-packed lanes
    _assert_device_matches_host_twin(16_384, reference=True)


@pytest.mark.slow
def test_text_128k_device_matches_host_twin():
    # 131_072 rows: the int32 wide-lane path (N >= 2^15)
    _assert_device_matches_host_twin(131_072, reference=False)


def _assert_device_matches_opset_charwise(n_ops: int) -> None:
    changes = _trace_shaped(n_ops)
    opset = OpSet()
    opset.apply_changes(changes)
    doc = opset.materialize()
    want = str(doc["t"])
    assert isinstance(doc["t"], Text) and len(want) > 100

    dec = materialize_batch([changes], device="cpu")
    assert _device_text(dec) == want
    assert dec.clock_dict(0) == opset.clock


def test_text_4k_device_matches_opset_charwise():
    _assert_device_matches_opset_charwise(4_096)


@pytest.mark.slow
def test_text_8k_device_matches_opset_charwise():
    _assert_device_matches_opset_charwise(8_192)
