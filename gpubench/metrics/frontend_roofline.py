"""The frontend kernels' share of their roofline, in percent: the least
time of one launch at the cell's shapes (gpubench/yardstick/roofline.py)
over the mean device time of a launch of `frontend_linear_kernel` or
`frontend_features_kernel`. Each launch serves one card's rows."""

from gpubench.yardstick.roofline import frontend_bound

KERNELS = ("frontend_linear_kernel", "frontend_features_kernel")
MODES = {"hybrid": "linear", "librosa": "mel", "mfcc": "mfcc", "log_mel": "log_mel"}


def read(ctx):
    launches = [k for k in ctx.trace.kernels if any(n in k.name for n in KERNELS)]
    if not launches:
        return None
    m = ctx.config
    mode = MODES[m["audio_frontend"]]
    int8 = any(", true>" in k.name for k in launches)
    least_ms, _ = frontend_bound(
        mode, m["mag_scale"] if mode == "mel" else "none", rows=ctx.rows // ctx.cards,
        samples=int(m["sample_rate"] * m["chunk_duration"]), n_fft=m["fft_length"],
        sample_rate=m["sample_rate"], mel_bins=m["num_mels"], n_mfcc=m["n_mfcc"],
        spec_width=m["spec_width"], int8=int8)
    mean_ms = sum(k.dur for k in launches) * 1e-3 / len(launches)
    return 100.0 * least_ms / mean_ms
