"""Dynamic loss scaling: the port's ``mxnet_tpu/amp/loss_scaler.py``
(the reference's ``python/mxnet/amp/loss_scaler.py``)."""
from __future__ import annotations


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        # set by amp.unscale() (the manual grad-clipping flow): the next
        # trainer step must not fold 1 / loss_scale into rescale_grad a
        # second time; the step resets it
        self._manual_unscaled = False

    def has_overflow(self, params):
        """True if any gradient is inf or NaN: ``fault.grads_finite``,
        one ``multi_all_finite`` kernel launch over the gradients on the
        card and one host sync (the check the Trainer's non-finite step
        guard shares)."""
        from ..fault import grads_finite
        return not grads_finite(params)

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
        return not overflow
