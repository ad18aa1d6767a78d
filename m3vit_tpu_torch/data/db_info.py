"""Label-space metadata for the multi-task datasets.

These tables are data definitions from the ASTMT/M3ViT label spaces — they
must be byte-identical for metric parity (reference:
data/pascal_context.py:38-67 and data/db_info/*.json).
"""

# Merge map from raw PASCAL-Part names to K-part label ids, per granularity
# (reference: data/pascal_context.py HUMAN_PART, :38-55)
HUMAN_PART = {
    1: {
        "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "lfoot": 1,
        "lhand": 1, "llarm": 1, "llleg": 1, "luarm": 1, "luleg": 1, "mouth": 1,
        "neck": 1, "nose": 1, "rear": 1, "rebrow": 1, "reye": 1, "rfoot": 1,
        "rhand": 1, "rlarm": 1, "rlleg": 1, "ruarm": 1, "ruleg": 1, "torso": 1,
    },
    4: {
        "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "lfoot": 4,
        "lhand": 3, "llarm": 3, "llleg": 4, "luarm": 3, "luleg": 4, "mouth": 1,
        "neck": 2, "nose": 1, "rear": 1, "rebrow": 1, "reye": 1, "rfoot": 4,
        "rhand": 3, "rlarm": 3, "rlleg": 4, "ruarm": 3, "ruleg": 4, "torso": 2,
    },
    6: {
        "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "lfoot": 6,
        "lhand": 4, "llarm": 4, "llleg": 6, "luarm": 3, "luleg": 5, "mouth": 1,
        "neck": 2, "nose": 1, "rear": 1, "rebrow": 1, "reye": 1, "rfoot": 6,
        "rhand": 4, "rlarm": 4, "rlleg": 6, "ruarm": 3, "ruleg": 5, "torso": 2,
    },
    14: {
        "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "lfoot": 14,
        "lhand": 8, "llarm": 7, "llleg": 13, "luarm": 6, "luleg": 12, "mouth": 1,
        "neck": 2, "nose": 1, "rear": 1, "rebrow": 1, "reye": 1, "rfoot": 11,
        "rhand": 5, "rlarm": 4, "rlleg": 10, "ruarm": 3, "ruleg": 9, "torso": 2,
    },
}

VOC_CATEGORY_NAMES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# PASCAL-Context class ids whose surfaces carry valid distilled normals:
# NYU classes intersected with context classes + tvmonitor
# (reference: data/pascal_context.py:122-134 over data/db_info/*.json)
NORMALS_VALID_CLASSES = [
    3, 4, 6, 9, 10, 11, 13, 15, 17, 18, 22, 23, 29, 30, 33, 34, 36, 37, 38,
    39, 41, 43, 46, 49, 50, 51, 53, 55, 56, 59, 61, 62, 65, 66, 68, 69, 72,
    73, 78, 83, 84, 85, 87, 88, 95, 96, 101, 104, 105, 107, 111, 113, 115,
    122, 124, 135, 141, 142, 143, 146, 150, 154, 157, 158, 159, 165, 172,
    174, 181, 183, 184, 191, 193, 195, 197, 199, 202, 213, 215, 216, 219,
    220, 223, 225, 228, 230, 232, 233, 238, 239, 242, 243, 246, 250, 251,
    252, 255, 260, 261, 263, 269, 272, 273, 275, 281, 283, 284, 285, 286,
    287, 288, 290, 291, 292, 293, 295, 304, 307, 309, 310, 314, 315, 319,
    323, 329, 330, 331, 336, 342, 345, 349, 350, 351, 352, 355, 357, 368,
    370, 371, 374, 379, 380, 383, 384, 397, 401, 403, 405, 407, 408, 411,
    412, 413, 414, 417, 419, 421, 423, 427, 429, 430, 432, 440, 441, 442,
    443, 444, 446, 454, 457,
]
