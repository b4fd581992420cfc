"""Records of the hand-written kernels' calls in a traced window: wrappers
around the kernel layer's launch functions, installed for traced runs only
and removed after the window.

K2: `ops.kernels.conv_fused.launch` (every K2 launch goes through it).
K1: the pass functions of `ops.kernels.mbconv` that `mbconv_infer_nchw`
looks up when it runs.
"""

from __future__ import annotations

K1_PASSES = {"mbconv_nhwc_pass1": 1, "mbconv_nhwc_pass2": 2,
             "mbconv_nhwc_expand_pass1": 1, "mbconv_nhwc_expand_pass2": 2,
             "mbconv_pass1": 1, "mbconv_pass2": 2}


class KernelCalls:
    """K2 calls as (n, h, w, cin, cout, element size); K1 passes as (pass,
    n, cin, h, w, mid, cout, expand, element size)."""

    def __init__(self):
        from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

        self.k2, self.k1 = [], []
        self._restore = []

        def patch(mod, name, fn):
            self._restore.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

        launch = conv_fused.launch

        def recording_launch(variant, x, packed, relu):
            n, h, w, cin = x.shape
            self.k2.append((n, h, w, cin, packed.cout, x.element_size()))
            return launch(variant, x, packed, relu)

        patch(conv_fused, "launch", recording_launch)
        for name, which in K1_PASSES.items():
            patch(mbconv, name, self._k1_recorder(getattr(mbconv, name), which))

    def _k1_recorder(self, fn, which):
        def recording(x, p, *args, **kwargs):
            n, cin, h, w = x.shape
            self.k1.append((which, n, cin, h, w, p.wdw.shape[0], p.wproj.shape[1],
                            p.wexp is not None, x.element_size()))
            return fn(x, p, *args, **kwargs)
        return recording

    def remove(self) -> None:
        for mod, name, fn in reversed(self._restore):
            setattr(mod, name, fn)
        self._restore.clear()

    def counts(self) -> dict:
        return {"k2_calls": list(self.k2), "k1_calls": list(self.k1)}
