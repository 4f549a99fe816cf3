"""train_img_per_s (img/s) from a traced run: the valid training images of
the window's untraced rounds over their seconds, as the end-to-end metric
counts them. Where a cell's end-to-end rate swings with the host's speed
beyond any bound (``train_img_per_s.b0``), it is read here, unbounded."""


def read(rec: dict):
    u = rec.get("untraced")
    if not u or u["seconds"] <= 0 or not u.get("images"):
        return None
    return u["images"] / u["seconds"]
