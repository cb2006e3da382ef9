"""BBZ (Berliner Börsen-Zeitung) transcription harmonization schema.

Role of the reference's origami/custom/harmonizations/bbz.py, re-authored
for this engine at full depth: the "unstyled"/"styled" channel pair with
their alphabets and the complete normalization behavior (historic quote
conventions, dash/fraction/degree folding, price-"à" spacing, punctuation
and parenthesis whitespace, style-bracket handling) plus our additional
"fraktur"/"modern" channels for long-s era glyph folding. The embedded
test corpus pins the transform pair behavior; run via
`python -m origami_tpu_torch.tool.harmonize bbz --test --device cpu`.

Styled transcriptions mark bold with [] and spaced type with {}; the
styled channel keeps those annotations but normalizes punctuation to sit
OUTSIDE the brackets, the unstyled channel drops them entirely.
"""

_LOWER = "abcdefghijklmnopqrstuvwxyzß"
_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_LOWER_DIA = "äöüàáâôéèêëç"
_UPPER_DIA = "ÄÖÜ"

SCHEMA = {
    "channels": {
        "unstyled": {
            "transform": "unstyled",
            "alphabet": {
                "lowercase": _LOWER,
                "uppercase": _UPPER,
                "lowercase_diacritic": _LOWER_DIA,
                "uppercase_diacritic": _UPPER_DIA,
                "punctuation": "-?!.,:; ",
                "quotes": "‚'",
                "brackets": "()<>",
                "slashes": "/",
                "math": "+=%",
                "footnote": "*†",
                "digits": "1234567890",
                "currencies": "£$",
                "symbols": "§&△",
            },
            "tests": ["common", "unstyled"],
        },
        "styled": {
            "transform": "styled",
            "alphabet": {
                "lowercase": _LOWER,
                "uppercase": _UPPER,
                "lowercase_diacritic": _LOWER_DIA,
                "uppercase_diacritic": _UPPER_DIA,
                "punctuation": "-?!.,:;‚' ",
                "brackets": "()<>",
                "slashes": "/",
                "math": "+=%",
                "footnote": "*†",
                "digits": "1234567890",
                "currencies": "£$",
                "symbols": "§&△",
                "styles": "{}[]",
            },
            "tests": ["common", "styled"],
        },
        "default": {
            "transform": "unstyled",
            "alphabet": None,
            "tests": [],
        },
        # glyph-level channels for long-s era Fraktur transcriptions
        "fraktur": {
            "transform": "fraktur",
            "alphabet": None,
            "tests": ["fraktur"],
        },
        "modern": {
            "transform": "modern",
            "alphabet": None,
            "tests": ["modern"],
        },
    },
    "tests": {
        "styled": [
            ("{a} [b]", "{a} [b]"),
            ("- [a]", "- [a]"),
            ("[- a]", "- [a]"),
            ("[-a]", "-[a]"),
            ("-[a]", "-[a]"),
            ("--[a]", "--[a]"),
            ("[a.]", "[a]."),
            ("[a,]", "[a],"),
            ("[a:]", "[a]:"),
            ("[a;]", "[a];"),
            ("[a?]", "[a]?"),
            ("[a!]", "[a]!"),
            ("[a) {b}]", "[a) {b}]"),
        ],
        "unstyled": [
            ("{a} [b]", "a b"),
        ],
        "common": [
            ("a  b c", "a b c"),
            ("a.b", "a. b"),
            ("3.4", "3.4"),
            ("a,b", "a, b"),
            ("a:b", "a: b"),
            ("a .b", "a. b"),
            ("a ,b", "a, b"),
            ("a ( b ) c", "a (b) c"),
            ("a ( b ) , c", "a (b), c"),
            ("a ( b ) . c", "a (b). c"),
            ("a„  b ”c", "a ‚‚b'' c"),
            ("a  '  b", "a ' b"),
            ("a 3. 7. 14.). b", "a 3. 7. 14.). b"),
            ("1 %", "1%"),
            ("12 -- 34", "12 -- 34"),
            ("Stückà3", "Stück à 3"),
            ("a\"b", "a'' b"),
            ("a'''b", "a''' b"),
            ("a„b", "a ‚‚b"),
            ("a‚‚‚b", "a ‚‚‚b"),
            ("3 + 4", "3 + 4"),
            ("a + 4", "a + 4"),
            ("a - b", "a - b"),
            ("a- b", "a- b"),
            ("a-", "a-"),
            ("3,4", "3,4"),
            ("3, 4", "3, 4"),
            ("a.)", "a.)"),
            ("a!b", "a! b"),
            ("a!)", "a!)"),
            ("a?b", "a? b"),
            ("a?)", "a?)"),
            ("Thlr. .", "Thlr.."),
            ("Thlr..", "Thlr.."),
            ("½ Stück", "<1/2> Stück"),
            ("5° a", "5<0 a"),
            ("a ― b", "a -- b"),
        ],
        "fraktur": [
            ("Caſſa  Bericht", "Caſſa Bericht"),
            ("Börſe ,  Berlin", "Börſe, Berlin"),
        ],
        "modern": [
            ("Caſſa", "Cassa"),
            ("Actiengeſellſchaft", "Actiengesellschaft"),
            ("Wien ⸗ Brief", "Wien-Brief"),
        ],
    },
    "transforms": {
        "unstyled": [
            # drop style annotations entirely, then normalize
            ("re", r"[{}\[\]]", ""),
            ("tfm", "core"),
        ],
        "styled": [
            ("tfm", "core"),
            # punctuation sits OUTSIDE style brackets: move any leading
            # / trailing non-word runs across the bracket. The ]<->}
            # moves cancel for nested "...}]" endings, which is what
            # keeps well-nested annotations stable.
            ("re", r"([^\w]+)\]", r"]\g<1>"),
            ("re", r"\[([^\w]+)", r"\g<1>["),
            ("re", r"([^\w]+)\}", r"}\g<1>"),
            ("re", r"\{([^\w]+)", r"\g<1>{"),
            ("re", r"\s+", " "),
        ],
        "core": [
            # canonical nesting of touching style brackets
            ("re", r"\{\s*\[", "[{"),
            ("re", r"\]\s*\}", "}]"),
            # dash variants
            ("str", "―", "--"),
            ("str", "•", "-"),
            # historic quotes become comma / apostrophe pairs
            ("str", "”", "''"),
            ("str", "„", "‚‚"),
            ("str", "\"", "''"),
            # opening quotes bind right (space before, none after) ...
            ("re", r"([^‚\s])‚‚", r"\g<1> ‚‚"),
            ("re", r"‚‚\s+", "‚‚"),
            # ... closing quotes bind left
            ("re", r"''([^'\s])", r"'' \g<1>"),
            ("re", r"\s+''", "''"),
            # composite glyphs expand to bracketed ASCII
            ("str", "½", "<1/2>"),
            ("str", "¼", "<1/4>"),
            ("str", "¾", "<3/4>"),
            ("str", "°", "<0 "),
            # the price preposition "à" stands alone
            ("re", r"à([0-9]+)", r" à \g<1>"),
            # punctuation is followed by a space (never between digits,
            # so 3,4 / 3.4 prices survive) ...
            ("str", ":", ": "),
            ("str", ";", "; "),
            ("re", r"\.\s*([^\W\d]+)", r". \g<1>"),
            ("re", r"([^0-9]+)\s*,\s*([^0-9]+)", r"\g<1>, \g<2>"),
            ("re", r"!\s*([^\W\d]+)", r"! \g<1>"),
            ("re", r"\?\s*([^\W\d]+)", r"? \g<1>"),
            ("re", r"Thlr\.\s+\.", "Thlr.."),
            # ... and never preceded by one
            ("re", r"\s+([:;.,!?])", r"\g<1>"),
            # parentheses hug their content; punctuation hugs the
            # closing parenthesis from either side
            ("re", r"\s+\)", ")"),
            ("re", r"\(\s+", "("),
            ("re", r"\)\s+([:;.,!?])", r")\g<1>"),
            ("re", r"([.!?])\s+\)", r"\g<1>)"),
            # numeric ranges keep a spaced double dash; percent binds
            ("re", r"([0-9])\s*--\s*([0-9])", r"\g<1> -- \g<2>"),
            ("re", r"([0-9])\s+%", r"\g<1>%"),
            ("re", r"\s+", " "),
        ],
        "base": [
            ("unicode", "NFC"),
            ("str", "⸗", "-"),
            ("str", "—", "-"),
            ("re", r"\s+", " "),
            ("re", r"\s*([,;:.!?])\s*", r"\1 "),
            ("re", r"(\d) *([,%-]+) *(\d)", r"\1\2\3"),
            ("re", r"\( +", "("),
            ("re", r" +\)", ")"),
            ("re", r" *- *", "-"),
        ],
        "fraktur": [
            ("tfm", "base"),
        ],
        "modern": [
            ("tfm", "base"),
            ("str", "ſ", "s"),
            ("str", "ꝛ", "r"),
            ("str", "æ", "ae"),
            ("str", "œ", "oe"),
        ],
    },
}
