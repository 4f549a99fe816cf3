"""Where a round's step images come from: the training table on the device,
or a packed shard on disk read through a ``PackLoader`` (``data.host_stream``;
the JAX package's ``Trainer.local_pass`` and ``_windowed_pass``,
``fedmlp_tpu/train.py:486-597``).

An engine opens its round's source in the order it consumes steps ('client':
the per-client loop, clients outside and steps inside; 'step': the lockstep
and stacked engines, steps outside and all K clients inside) and asks it for
one client's step images, ``client_step(k, s)`` u8 [B, H, W, 3], or for one
step of every client, ``step(s)`` u8 [K, B, H, W, 3]; ``whole()`` is the
round's [S, K, B, H, W, 3], for the views a round makes before its first step.
Every source returns the same bytes for the same plan position, and none
draws from a generator, so a streamed round is the resident round bit for bit.

With ``stream_window=0`` the round's [S, K, B] images are gathered from the
loader at once, as in JAX. With ``stream_window=W`` the round streams in
windows of W steps in the engine's order, padding steps left out (no engine
reads them): W steps of one client (W·B images) on the per-client loop, W
steps of all K clients (W·K·B, JAX's window) on the lockstep engine. The
loader gathers window w+1 on its thread while window w trains; window w is
dropped before w+1 lands, so at most two windows' rows are held at once, one
on the device and one in the loader (``peak_rows``). The windows change no
arithmetic and no draw, so unlike JAX's jitted round no Adam or generator
state is carried between them.
"""

from __future__ import annotations

import numpy as np
import torch


class TableImages:
    """Step images indexed from the device-resident table u8 [N, H, W, 3]
    through the client index table ``idx`` [K, M] at the plan's positions
    ``pos`` [S, K, B] (device tensors)."""

    def __init__(self, images: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor):
        self.images, self.idx, self.pos = images, idx, pos
        self.rows = torch.arange(idx.shape[0], device=idx.device)[:, None]

    def client_step(self, k: int, s: int) -> torch.Tensor:
        return self.images[self.idx[k, self.pos[s, k]]]

    def step(self, s: int) -> torch.Tensor:
        return self.images[self.idx[self.rows, self.pos[s]]]

    def whole(self) -> torch.Tensor:
        return self.images[self.idx[self.rows[None], self.pos]]

    def finish(self) -> None:
        pass


class GatheredImages:
    """The round's [S, K, B] images gathered from the loader in one call
    (``stream_window=0``) and sent to the device."""

    def __init__(self, stream: "RoundStream"):
        self.imgs = stream.loader.to_device(stream.loader.gather(stream.gidx), stream.device)

    def client_step(self, k: int, s: int) -> torch.Tensor:
        return self.imgs[s, k]

    def step(self, s: int) -> torch.Tensor:
        return self.imgs[s]

    def whole(self) -> torch.Tensor:
        return self.imgs

    def finish(self) -> None:
        pass


class WindowedImages:
    """The round in windows of ``stream.window`` steps in the engine's
    ``order``, each window gathered by the loader while the one before it
    trains. Asking for a step outside the current and the next window raises:
    the engine and the windows disagree on the order."""

    def __init__(self, stream: "RoundStream", order: str):
        self.loader, self.device = stream.loader, stream.device
        S, K, _ = stream.gidx.shape
        W = stream.window
        live = np.asarray(stream.pos_valid).any(2)  # [S, K]: the steps an engine runs
        self.windows = []  # (keys, rows [n, B] or [n, K, B])
        if order == "client":
            for k in range(K):
                steps = np.flatnonzero(live[:, k])
                for c in range(0, len(steps), W):
                    part = steps[c:c + W]
                    self.windows.append(([(k, int(s)) for s in part], stream.gidx[part, k]))
        elif order == "step":
            steps = np.flatnonzero(live.any(1))
            for c in range(0, len(steps), W):
                part = steps[c:c + W]
                self.windows.append(([int(s) for s in part], stream.gidx[part]))
        else:
            raise ValueError(f"unknown order {order!r}")
        self.order = order
        self.next = 0  # the window the loader holds or gathers
        self.cur, self.slot = None, {}
        self.stream = stream
        self._submit()

    def _submit(self) -> None:
        if self.next < len(self.windows):
            self.loader.submit(self.windows[self.next][1])

    def _get(self, key) -> torch.Tensor:
        i = self.slot.get(key)
        if i is None:
            if self.next >= len(self.windows) or key not in self.windows[self.next][0]:
                raise RuntimeError(f"step {key} is not in the next window: the engine "
                                   f"reads in another order than {self.order!r}")
            keys, rows = self.windows[self.next]
            self.cur = None  # window w goes before window w+1 lands
            host = self.loader.wait()
            self.next += 1
            self._submit()
            self.cur = self.loader.to_device(host, self.device)
            self.slot = {kk: j for j, kk in enumerate(keys)}
            pending = (self.windows[self.next][1].size if self.next < len(self.windows)
                       else 0)
            self.stream.peak_rows = max(self.stream.peak_rows, int(rows.size + pending))
            i = self.slot[key]
        return self.cur[i]

    def client_step(self, k: int, s: int) -> torch.Tensor:
        return self._get((k, s))

    def step(self, s: int) -> torch.Tensor:
        return self._get(s)

    def whole(self) -> torch.Tensor:
        raise ValueError("a windowed round holds two windows at most, never the "
                         "whole round (data.stream_window with views made before "
                         "the steps is refused)")

    def finish(self) -> None:
        """Check that the engine read every window."""
        if self.next < len(self.windows):
            raise RuntimeError(f"the round read {self.next} of {len(self.windows)} windows")
        self.cur = None


class RoundStream:
    """A round's images on disk: the ``loader``, the round's global sample
    indices ``gidx`` [S, K, B] (numpy), the plan's ``pos_valid`` [S, K, B],
    the window (0: the whole round at once) and the device the images go
    to. ``open(order)`` hands an engine its source; ``peak_rows`` is the
    most image rows any of them held at once."""

    def __init__(self, loader, gidx: np.ndarray, pos_valid: np.ndarray, window: int, device):
        if window < 0:
            raise ValueError(f"stream_window must be >= 0, got {window}")
        self.loader, self.window, self.device = loader, window, torch.device(device)
        self.gidx = np.ascontiguousarray(gidx, np.int64)
        self.pos_valid = pos_valid
        self.peak_rows = 0
        self._gathered = None

    def open(self, order: str):
        """A source of the round in the engine's ``order``; without a window
        the one gathered round, however often it is opened."""
        if self.window:
            return WindowedImages(self, order)
        if self._gathered is None:
            self._gathered = GatheredImages(self)
            self.peak_rows = int(self.gidx.size)
        return self._gathered


def open_round_images(images, idx: torch.Tensor, pos: torch.Tensor, order: str):
    """The source an engine reads its round from: ``images`` is the device
    table u8 [N, H, W, 3] or a ``RoundStream``."""
    if isinstance(images, RoundStream):
        return images.open(order)
    return TableImages(images, idx, pos)
