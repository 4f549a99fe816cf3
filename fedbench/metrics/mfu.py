"""mfu (%): the model FLOPs that the window's untraced rounds needed (each
trained forward F, its backward 2F, each frozen-global or harvest forward F;
recomputation not counted; F from ``fedbench/flops/``), over their seconds,
over the card's published dense peak in the configuration's compute type
(``fedbench/peaks.py``). Moves ``train_img_per_s``."""


def read(rec: dict):
    u = rec.get("untraced")
    if not u or u["seconds"] <= 0 or u["flops"] <= 0:
        return None
    return 100.0 * u["flops"] / u["seconds"] / rec["peak_flops"]
