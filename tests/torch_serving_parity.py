"""Helpers of the serving tier's parity tests (not a test module).

The port's serving tier is held to the JAX package's report for report:
the same call on both packages, compared as sorted-key JSON, and every
checkpoint-shard blob the two front ends pack (the migration and KV
handoffs, the failover snapshots) compared byte for byte.
"""

import json

import smi_tpu.serving.frontend as JFE
import smi_tpu.serving.inference as JINF
import smi_tpu_torch.serving.frontend as FE
import smi_tpu_torch.serving.inference as INF


def canon(value) -> str:
    """Sorted-key JSON: the form in which reports are held equal."""
    return json.dumps(value, sort_keys=True)


def frontend_state(fe) -> str:
    """A front end's whole observable state after a run: its report,
    its flight recorder's snapshot, its metrics snapshot and its SLO
    health."""
    return canon({
        "report": fe.report(),
        "recorder": fe.recorder.snapshot(),
        "metrics": fe.metrics.snapshot(),
        "health": fe.slo.health(),
    })


class BlobCapture:
    """Records every ``pack_shard`` call of both packages' front end and
    inference engine: ``(rank, step, payload, blob, crc)`` in call order,
    one list a package."""

    def __init__(self, monkeypatch):
        self.blobs = {"jax": [], "torch": []}
        for side, modules in (("jax", (JFE, JINF)), ("torch", (FE, INF))):
            for module in modules:
                monkeypatch.setattr(module, "pack_shard",
                                    self._recording(side, module.pack_shard))

    def _recording(self, side, pack):
        def pack_shard(rank, step, payload):
            blob, crc = pack(rank, step, payload)
            self.blobs[side].append((rank, step, bytes(payload), blob, crc))
            return blob, crc
        return pack_shard

    def assert_equal(self, at_least: int = 1) -> None:
        """Both packages packed the same blobs, byte for byte, and at
        least ``at_least`` of them."""
        ours, theirs = self.blobs["torch"], self.blobs["jax"]
        assert len(ours) >= at_least, ours
        assert len(ours) == len(theirs)
        for mine, other in zip(ours, theirs):
            assert mine == other
