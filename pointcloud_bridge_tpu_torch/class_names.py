"""Class-name maps (Highway_bridge/config/statistics_config.yaml +
inference.py:70 / train_MulSca_PN2.py:27 / Partsize test_sem_seg.py:30-36)."""

# 5-class road bridges (Highway_bridge trainers/inference)
ROAD_5C = {
    0: "noise",
    1: "abutment",
    2: "girder",
    3: "slab",  # deck
    4: "parapet",
}

# 8-class YBC steel bridges (inference.py:70)
YBC_8C = {
    0: "Background",
    1: "U_Flg",
    2: "Web",
    3: "B_Flg",
    4: "Vert_Stiff",
    5: "Horiz_Stiff",
    6: "Gusset",
    7: "Other",
}

# Partsize class order (test_sem_seg.py:30-36, Partsize classes.csv)
PARTSIZE_5C = {
    0: "abutment",
    1: "girder",
    2: "deck",
    3: "parapet",
    4: "noise",
}


def names_list(mapping: dict) -> list:
    return [mapping[i] for i in sorted(mapping)]
