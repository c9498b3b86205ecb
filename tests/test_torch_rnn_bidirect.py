"""The bidirectional cases of ``test_torch_rnn_layers.py``: the stacked
``SimpleRNN`` (tanh and relu), ``LSTM`` and ``GRU`` with
``direction="bidirect"`` at 1 and 2 layers, both layouts, with and without
initial states, against ``paddle_tpu/nn/layer/rnn.py`` on the CPU (its
``stacked_case``: outputs, final states and every gradient by
``jax.vjp``). A file of its own so that each stays under a minute.

Tolerances: fp32, outputs within 1e-5 of the largest |value| (sums in
another order, over the steps), gradients within 1e-4 of the largest.
"""
import pytest

from test_torch_rnn_layers import MODES, stacked_case


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("time_major,given", [(False, True), (True, False)],
                         ids=["batch_major-states", "time_major-zeros"])
def test_bidirectional_layer_matches_jax(mode, layers, time_major, given):
    stacked_case(mode, layers, "bidirect", time_major, given)
