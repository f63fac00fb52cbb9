"""Kernels the traced training slice launched, per second of real audio it
trained on."""


def read(m: dict):
    tr = m.get("trace")
    if not tr or not tr["real_audio_s"]:
        return None
    return tr["kernels"] / tr["real_audio_s"]
