"""Default transcription harmonization schema.

Normalizes whitespace, punctuation spacing and common OCR-model quote/
dash variants into a single convention (role of the reference's default
schema, origami/custom/harmonizations/default.py — rules re-authored)."""

SCHEMA = {
    "channels": {
        "default": {
            "transform": "default",
            "alphabet": None,
            "tests": ["default"],
        },
    },
    "tests": {
        "default": [
            ("a  b   c", "a b c"),
            ("a ,b", "a, b"),
            ("a .b", "a. b"),
            ("a;b", "a; b"),
            ("wort⸗", "wort-"),
            ("a ( b )", "a (b)"),
            ("1 %", "1%"),
            ("12 - 34", "12-34"),
        ],
    },
    "transforms": {
        "default": [
            ("unicode", "NFC"),
            # dash variants -> plain hyphen
            ("str", "⸗", "-"),
            ("str", "—", "-"),
            ("str", "–", "-"),
            # collapse whitespace
            ("re", r"\s+", " "),
            # no space before, one space after sentence punctuation
            ("re", r"\s*([,;:.!?])\s*", r"\1 "),
            # keep decimal/ordinal groupings tight: "3. 7." style stays,
            # but digits around , - % join up
            ("re", r"(\d) *([,%-]+) *(\d)", r"\1\2\3"),
            ("re", r"(\d) *%", r"\1%"),
            # brackets hug their content
            ("re", r"\( +", "("),
            ("re", r" +\)", ")"),
            # fix spacing introduced after digits followed by ) etc.
            ("re", r" +$", ""),
            ("re", r"^ +", ""),
        ],
    },
}
