"""Share of the window's batch samples that are padding: 1 - real samples
over batch rows x bucket samples, from the batches the loader made."""


def read(m: dict):
    return 100.0 * (1.0 - m["real_audio_s"] / m["padded_audio_s"])
