"""Closed categorical vocab + LLM 'RE' feature-field schema.

Mechanism mirrors the reference (`utils/vocab.py:421-444`): a per-field
closed vocabulary flattened into ONE global token->id map with PAD=0 and
UNK=1, ids starting at 2, plus the 9 LLM-derived field tags
(`RE_FEATURE_KEYS`, reference `utils/vocab.py:421-424`) and the
natural-language field prompts used when serializing RE values for the text
branch (`FIELD_PROMPT_MAP`, reference `item_tower.py:445-464`).

The default value lists below are our own compact fashion taxonomy (enough
for the synthetic H&M-style dataset); production vocabularies load from a
JSON file via ``StdVocab.from_json`` — the vocab is *data*, the mechanism is
what the framework owns. Everything here is static and stateless, so the
tokenization path is trivially race-free (SURVEY.md §5 "Race detection").
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

PAD_ID = 0
UNK_ID = 1

# The 9 LLM-enrichment field tags: category, material, detail, fit,
# function, special, color, context, location-on-body.
RE_FEATURE_KEYS: tuple[str, ...] = (
    "CAT", "MAT", "DET", "FIT", "FNC", "SPC", "COL", "CTX", "LOC",
)

# Natural-language prompt prefix per RE field, prepended before tokenizing
# field values for the text encoder.
FIELD_PROMPTS: dict[str, str] = {
    "CAT": "Garment Category:",
    "MAT": "Fabric Material:",
    "DET": "Design Detail:",
    "FIT": "Fit and Silhouette:",
    "FNC": "Function:",
    "SPC": "Special Attribute:",
    "COL": "Color Tone:",
    "CTX": "Wearing Context:",
    "LOC": "Body Location:",
}

# Our own compact default taxonomy for the six structured H&M-style fields.
DEFAULT_STD_VOCAB: dict[str, list[str]] = {
    "product_type_name": [
        "tshirt", "shirt", "blouse", "sweater", "hoodie", "cardigan", "vest",
        "jacket", "coat", "blazer", "dress", "skirt", "trousers", "jeans",
        "shorts", "leggings", "top", "bodysuit", "jumpsuit", "pyjama",
        "swimwear", "underwear", "bra", "socks", "tights", "hat", "cap",
        "scarf", "gloves", "belt", "bag", "shoes", "sneakers", "boots",
        "sandals", "earring", "necklace", "sunglasses",
    ],
    "graphical_appearance_name": [
        "solid", "stripe", "check", "dot", "melange", "denim_look",
        "print_all_over", "print_placement", "colour_block", "glitter",
        "metallic", "lace_look", "embroidery", "jacquard", "washed",
        "treatment", "transparent", "neon", "mixed",
    ],
    "colour_group_name": [
        "black", "white", "off_white", "grey", "dark_grey", "light_grey",
        "beige", "brown", "dark_brown", "khaki", "green", "dark_green",
        "light_green", "turquoise", "blue", "dark_blue", "light_blue",
        "navy", "purple", "lilac", "pink", "light_pink", "dark_pink", "red",
        "dark_red", "orange", "yellow", "light_yellow", "gold", "silver",
    ],
    "department_name": [
        "jersey_basic", "jersey_fancy", "knitwear", "outdoor", "trouser",
        "denim", "dresses", "skirts", "blouse_dept", "shirt_dept",
        "swimwear_dept", "nightwear", "underwear_dept", "accessories",
        "shoes_dept", "sport", "kids_basic", "kids_fancy", "mama",
        "tailoring", "jacket_dept", "premium",
    ],
    "section_name": [
        "womens_everyday", "womens_trend", "womens_classic", "womens_casual",
        "mens_basic", "mens_trend", "mens_classic", "divided_basic",
        "divided_trend", "kids_girl", "kids_boy", "baby", "sportswear",
        "lingerie", "accessories_section", "footwear",
    ],
    "perceived_colour_value_name": [
        "dark", "dusty_light", "light", "medium", "medium_dusty", "bright",
        "undefined",
    ],
}

STD_FIELD_KEYS: tuple[str, ...] = tuple(DEFAULT_STD_VOCAB.keys())


class StdVocab:
    """Flattened global token->id map over the per-field closed vocabs."""

    def __init__(self, config: Mapping[str, Sequence[str]] | None = None):
        self.config = {k: list(v) for k, v in (config or DEFAULT_STD_VOCAB).items()}
        self.field_keys: tuple[str, ...] = tuple(self.config.keys())
        self.token_to_id: dict[str, int] = {}
        next_id = 2  # 0=PAD, 1=UNK
        for field in self.field_keys:
            for tok in self.config[field]:
                key = self._key(field, tok)
                if key not in self.token_to_id:
                    self.token_to_id[key] = next_id
                    next_id += 1
        self.size = next_id

    @staticmethod
    def _key(field: str, token: str) -> str:
        # field-qualified so identical strings in different fields get
        # distinct ids (the flattened-map behavior users rely on)
        return f"{field}={str(token).strip().lower()}"

    def get_id(self, field: str, token: str | None) -> int:
        if token is None or token == "":
            return PAD_ID
        return self.token_to_id.get(self._key(field, token), UNK_ID)

    def encode_item(self, fields: Mapping[str, str]) -> list[int]:
        """One id per STD field, in canonical field order -> fixed (F,) row."""
        return [self.get_id(f, fields.get(f)) for f in self.field_keys]

    @property
    def num_fields(self) -> int:
        return len(self.field_keys)

    @classmethod
    def from_json(cls, path: str) -> "StdVocab":
        with open(path) as f:
            return cls(json.load(f))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.config, f, indent=1)
