"""k2_roofline (%): the env MLP kernel's (K2, ``env_mlp_kernel``) least
time over its device time in the traced frames. The least time is the
escaped directions x 2 x the NIF's multiply-adds per direction (its
layers' widths, from the weight file) at 989 TFLOP/s, the H100 SXM's
dense bf16 peak (NVIDIA's data sheet, 700 W). The escaped directions of
each traced frame are counted by the plain reference's path tracer: by
the RNG contract the same for any correct renderer."""

from benchmark import program
from benchmark.metrics_lib import card_info, kernel_ms_per_frame
from benchmark.reference import path as RP
from benchmark.reference.nif import PlainNif

PEAK_FLOPS = 989e12


def read(run):
    ms = kernel_ms_per_frame(run, lambda n: "env_mlp" in n)
    cfg = run.cell.config
    if not ms or not cfg.get("nif"):
        return None
    dev = run.ref_device
    sc, tb = program.reference_tables(run.cell, dev)
    macs = PlainNif(run.cell.path(cfg["nif"]), dev).macs
    esc = [RP.escapes(tb, s, w=cfg["image_width"], h=cfg["image_height"],
                      spp=cfg["samples_per_pixel"],
                      chunk=int(run.cell.traffic["chunk"]), fov=sc.fov,
                      aa=cfg["anti_alias_scale"],
                      max_len=cfg["max_path_length"],
                      rr_depth=cfg["roulette_start_depth"], device=dev)
           for s in run.frame_seeds]
    least_ms = 1e3 * sum(esc) * 2 * macs / PEAK_FLOPS / run.frames
    run.log(f"k2_roofline: escapes per frame {esc}, {2 * macs} FLOP each, "
            f"least {least_ms:.4f} ms, K2 {ms:.4f} ms per frame; card "
            f"{card_info()}")
    return 100.0 * least_ms / ms
