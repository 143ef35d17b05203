"""Faults planted in the program's timed path, for the readings that a
limit's upper end is set from (``calibrate.py --fault``) and for the tests
that see ``correct`` come out false.  Each plants itself and returns the
function that takes it out again."""
from __future__ import annotations


def dice_half_planes():
    """The served dice counted over every second depth plane: a shortcut
    that would halve the scoring's cost, and moves each class's dice a
    little."""
    import deepatlas_torch.train as train
    orig = train.volume_dice

    def halved(pred, truth, n_classes, device):
        return orig(pred[::2], truth[::2], n_classes, device)

    train.volume_dice = halved
    return lambda: setattr(train, "volume_dice", orig)


def labels_plane():
    """The served labels altered on one depth plane of every tile, a plane
    that each tile's centre keeps: a wrong answer where it is produced."""
    import deepatlas_torch.train as train
    make = train.make_tile_predictor

    def altered(model, tile_batch=4):
        predict = make(model, tile_batch)

        def wrong(tiles):
            labels = predict(tiles).copy()
            mid = labels.shape[1] // 2
            k = max(int(labels.max()) + 1, 2)
            labels[:, mid] = (labels[:, mid] + 1) % k
            return labels
        return wrong

    train.make_tile_predictor = altered
    return lambda: setattr(train, "make_tile_predictor", make)


FAULTS = {"dice_half_planes": dice_half_planes, "labels_plane": labels_plane}
