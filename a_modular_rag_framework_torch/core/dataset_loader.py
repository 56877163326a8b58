"""Dataset loaders (L0 data plane).

The port's copy of ``a_modular_rag_framework_tpu/core/dataset_loader.py``.
HotpotQA JSON/JSONL loader with index/count slicing + a registry for future
sources, mirroring the reference implementation's
app/core/dataset_loader.py:6-59. Adds a
deterministic synthetic HotpotQA-style generator used by tests and benches
when no real dataset file is present (the environment has no network).
"""
from __future__ import annotations

import hashlib
import json
import random
from pathlib import Path
from typing import Any, Dict, List


class DatasetLoader:
    """Extensible dataset loader base."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg

    def load(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class HotpotQALoader(DatasetLoader):
    """Load HotpotQA samples from a JSON array or JSON-Lines file."""

    def load(self) -> List[Dict[str, Any]]:
        path = Path(self.cfg["path"])
        index = int(self.cfg.get("index", 0))
        count = int(self.cfg.get("count", 1))

        if not path.exists():
            raise FileNotFoundError(f"HotpotQA dataset not found at {path}")

        with open(path, "r", encoding="utf-8") as f:
            first_char = f.read(1)
            f.seek(0)
            if first_char == "[":
                data = json.load(f)
            else:
                data = [json.loads(line) for line in f if line.strip()]

        if count == -1:
            return data[index:]
        return data[index : index + count]


class SyntheticHotpotQALoader(DatasetLoader):
    """Deterministic synthetic multi-hop QA corpus.

    Generates samples with the HotpotQA schema:
      {"_id", "question", "answer", "type", "level",
       "context": [[title, [sent, ...]], ...],
       "supporting_facts": [[title, sent_id], ...]}

    Each sample encodes a 2-hop chain: entity A relates to bridge entity B in
    one document, and B relates to the answer C in another document, with
    distractor documents alongside — so Recall@k and multi-hop expansion are
    meaningfully exercised without network access.
    """

    FIRST = ["Alden", "Brisa", "Corin", "Dara", "Evren", "Fenn", "Gale",
             "Harlow", "Iris", "Jorah", "Kael", "Lior", "Mira", "Noor",
             "Orrin", "Pasha", "Quill", "Rowan", "Sage", "Tove"]
    LAST = ["Ashford", "Blackwood", "Caldwell", "Draven", "Ellsworth",
            "Fairbairn", "Greenfield", "Hawthorne", "Ingram", "Jessop",
            "Kingsley", "Lockhart", "Marchbanks", "Northcote", "Oakden",
            "Pemberton", "Quincey", "Ravenscroft", "Silverton", "Thackeray"]
    CITY = ["Veldoria", "Westmarch", "Xanthia", "Yarrowdale", "Zephyr Bay",
            "Amberfield", "Briarcliff", "Cinderfall", "Dunmore", "Eastvale",
            "Foxglove", "Gildenport", "Hollowbrook", "Ironridge", "Junewood",
            "Kestrel Point", "Larkspur", "Mistral Hollow", "Nightfen", "Oakhaven"]
    PROFESSION = ["architect", "botanist", "cartographer", "drummer",
                  "engineer", "falconer", "glassblower", "historian",
                  "illustrator", "jeweler", "kayaker", "librarian",
                  "mathematician", "novelist", "organist", "photographer"]

    SYLLABLES = ["an", "bel", "cor", "dra", "el", "fen", "gar", "hol", "in",
                 "jor", "kel", "lor", "mar", "nor", "or", "pel", "quin",
                 "rav", "sel", "tor", "ul", "ven", "wyn", "xan", "yor", "zel"]

    TOPIC = ["local history", "river navigation", "glass chemistry",
             "mountain flora", "early cartography", "harbor trade",
             "choral music", "printmaking", "bridge engineering",
             "coastal weather", "folk ballads", "timber architecture"]
    INSTITUTE = ["Northgate", "Riverside", "Halloway", "Crestfield",
                 "Windmere", "Stonebridge", "Lakeshore", "Fernhill"]

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__(cfg)
        self.n = int(cfg.get("count", 64) if cfg.get("count", 64) != -1 else 64)
        self.index = int(cfg.get("index", 0))
        self.seed = int(cfg.get("seed", 0))
        self.n_distractors = int(cfg.get("n_distractors", 8))
        # unique_entities: syllable-synthesized surnames keyed by a global
        # counter, so large corpora don't collapse under (title, sent_id)
        # dedup (the 20x20 name pools collide past ~400 docs)
        self.unique_entities = bool(cfg.get("unique_entities", False))
        # collide_entities: factored name pools — person #c gets first name
        # c % first_pool and surname (c // first_pool) % last_pool, so FULL
        # names (titles) stay unique up to first_pool*last_pool persons
        # while each first-name/surname TOKEN is shared by many people
        # across samples. At 5M rows every query's name tokens match
        # hundreds of distractor passages (like real fullwiki surnames), so
        # recall@k genuinely can fail — unlike unique_entities filler,
        # whose added passages share no tokens with any query (the round-2
        # scale-recall flaw). Pools are fixed constants so a prefix load
        # (count=2048) regenerates the exact questions of a larger cached
        # corpus.
        self.collide_entities = bool(cfg.get("collide_entities", False))
        self.first_pool = int(cfg.get("first_pool", 2048))
        self.last_pool = int(cfg.get("last_pool", 4096))
        # variety: varied sentence/question templates, filler sentences,
        # variable doc lengths, hard distractors (shared surnames/cities) —
        # a closer proxy for real HotpotQA text statistics
        self.variety = bool(cfg.get("variety", False))
        self._name_counter = 0

    def _synth_surname(self, idx: int) -> str:
        s = self.SYLLABLES
        parts = [s[idx % len(s)], s[(idx // len(s)) % len(s)],
                 s[(idx // (len(s) ** 2)) % len(s)]]
        # keep appending syllables past 26^3: a fixed 3-syllable scheme
        # repeats after 17,576 names, and at >17k docs colliding titles get
        # (title, sid)-deduped into the WRONG sample's sentences — gold
        # associations silently break at large corpus sizes
        idx //= len(s) ** 3
        while idx:
            parts.append(s[idx % len(s)])
            idx //= len(s)
        return "".join(parts).capitalize()

    def _person(self, rng: random.Random) -> str:
        if self.collide_entities:
            c = self._name_counter
            self._name_counter += 1
            # Knuth-mix the counter (odd multiplier -> bijection mod the
            # power-of-two pool product) so both name factors spread
            # uniformly at ANY corpus size; plain div/mod would reuse ~3
            # surnames for the first 6k persons
            m = (c * 2654435761) % (self.first_pool * self.last_pool)
            # even indices -> first names, odd -> surnames: the synthesis
            # is injective per index, so the two token vocabularies are
            # disjoint and a first name can never equal a surname
            first = self._synth_surname(2 * (m % self.first_pool))
            last = self._synth_surname(2 * (m // self.first_pool) + 1)
            return f"{first} {last}"
        if self.unique_entities:
            self._name_counter += 1
            return f"{rng.choice(self.FIRST)} {self._synth_surname(self._name_counter)}"
        return f"{rng.choice(self.FIRST)} {rng.choice(self.LAST)}"

    def _make_sample(self, i: int) -> Dict[str, Any]:
        rng = random.Random(f"{self.seed}:{i}")
        a = self._person(rng)
        b = self._person(rng)
        city = rng.choice(self.CITY)
        prof = rng.choice(self.PROFESSION)

        doc1_title = f"{a}"
        doc1_sents = [
            f"{a} was a {rng.choice(self.PROFESSION)} known for early work.",
            f"{a} collaborated closely with {b} for over a decade.",
            f"Later in life {a} retired from public view.",
        ]
        doc2_title = f"{b}"
        doc2_sents = [
            f"{b} was born in {city}.",
            f"{b} worked as a {prof} before turning to teaching.",
            f"{b} published several essays on local history.",
        ]
        context = [[doc1_title, doc1_sents], [doc2_title, doc2_sents]]
        for d in range(self.n_distractors):
            drng = random.Random(f"{self.seed}:{i}:d{d}")
            p = self._person(drng)
            c = drng.choice(self.CITY)
            context.append(
                [
                    f"{p}",
                    [
                        f"{p} was born in {c}.",
                        f"{p} spent years as a {drng.choice(self.PROFESSION)}.",
                    ],
                ]
            )
        rng.shuffle(context)

        question = f"In which city was the collaborator of {a} born?"
        sample_id = hashlib.sha1(f"{self.seed}:{i}".encode()).hexdigest()[:24]
        return {
            "_id": sample_id,
            "question": question,
            "answer": city,
            "type": "bridge",
            "level": "medium",
            "context": context,
            "supporting_facts": [[doc1_title, 1], [doc2_title, 0]],
        }

    # ---- variety mode ----

    def _filler(self, rng: random.Random, p: str) -> str:
        t = rng.choice(self.TOPIC)
        inst = rng.choice(self.INSTITUTE)
        year = rng.randrange(1890, 1990)
        return rng.choice([
            f"{p} received a regional medal in {year}.",
            f"{p} spent several years teaching at the {inst} institute.",
            f"{p} published essays on {t}.",
            f"Critics praised the work of {p} on {t}.",
            f"In {year} {p} moved away from public life.",
            f"{p} kept extensive notebooks about {t}.",
            f"Colleagues remembered {p} as a careful reader of {t}.",
        ])

    def _make_sample_variety(self, i: int) -> Dict[str, Any]:
        rng = random.Random(f"{self.seed}:{i}:v")
        a = self._person(rng)
        b = self._person(rng)
        city = rng.choice(self.CITY)
        prof = rng.choice(self.PROFESSION)

        question = rng.choice([
            f"In which city was the collaborator of {a} born?",
            f"Where was the longtime collaborator of {a} born?",
            f"The collaborator of {a} was born in which city?",
            f"In what city was the frequent collaborator of {a} born?",
        ])

        bridge_sent = rng.choice([
            f"{a} collaborated closely with {b} for over a decade.",
            f"Throughout a long career {a} collaborated with {b} on many projects.",
            f"{a} worked in close collaboration with {b}.",
            f"A celebrated collaboration linked {a} and {b} for years.",
        ])
        birth_sent = rng.choice([
            f"{b} was born in {city}.",
            f"{b} was born in the city of {city}.",
            f"{b} was born and raised in {city}.",
            f"Records show {b} was born in {city} to a family of artisans.",
        ])

        doc1_sents = [f"{a} was a {rng.choice(self.PROFESSION)} known for early work."]
        for _ in range(rng.randrange(0, 3)):
            doc1_sents.append(self._filler(rng, a))
        bridge_pos = rng.randrange(1, len(doc1_sents) + 1)
        doc1_sents.insert(bridge_pos, bridge_sent)

        doc2_sents = [birth_sent]
        doc2_sents.append(f"{b} worked as a {prof} before turning to teaching.")
        for _ in range(rng.randrange(0, 3)):
            doc2_sents.append(self._filler(rng, b))
        birth_pos = rng.randrange(0, 2)
        if birth_pos == 1:
            doc2_sents[0], doc2_sents[1] = doc2_sents[1], doc2_sents[0]

        context = [[a, doc1_sents], [b, doc2_sents]]
        n_dis = rng.randrange(max(2, self.n_distractors - 2),
                              self.n_distractors + 3)
        for d in range(n_dis):
            drng = random.Random(f"{self.seed}:{i}:vd{d}")
            p = self._person(drng)
            # hard distractors: reuse the answer city, or echo the
            # question's first name with a different surname
            if d == 0:
                p = f"{a.split()[0]} {p.split()[1]}"
            c = city if d == 1 else drng.choice(self.CITY)
            sents = [f"{p} was born in {c}."]
            for _ in range(drng.randrange(1, 4)):
                sents.append(self._filler(drng, p))
            context.append([p, sents])
        rng.shuffle(context)

        sample_id = hashlib.sha1(f"{self.seed}:{i}:v".encode()).hexdigest()[:24]
        return {
            "_id": sample_id,
            "question": question,
            "answer": city,
            "type": "bridge",
            "level": "medium",
            "context": context,
            "supporting_facts": [[a, bridge_pos], [b, birth_pos]],
        }

    # ---- held-out template families (selector-generalization eval) ----
    #
    # NEVER used during evidence-selector tuning (VERDICT r2 weak item 7):
    # new predicates (mentor/prize, sibling/employer, hometown/river), a
    # non-person bridge (a city document), and non-location answers. The
    # e2e EM on these families is the generalization check for the
    # anchor/twin/predicate selector heuristics tuned on the plain+variety
    # corpora.

    PRIZE = ["Hollman Prize", "Varden Medal", "Ostler Award", "Quillon Prize",
             "Bracken Medal", "Selwyn Honor", "Tarrow Prize", "Lindell Award"]
    COMPANY = ["Gildencorp Works", "Harrowgate Mills", "Vantage Foundry",
               "Bellweather Press", "Crestline Shipping", "Marrowfield Glass",
               "Northquay Timber", "Stellhaven Instruments"]
    RIVER = ["Arlen", "Brammel", "Corvane", "Dunwell", "Elderflow",
             "Farrow", "Greywater", "Hallbeck"]

    def _make_sample_heldout(self, i: int) -> Dict[str, Any]:
        rng = random.Random(f"{self.seed}:{i}:h")
        family = ("award", "employer", "river")[i % 3]
        a = self._person(rng)
        b = self._person(rng)
        city = rng.choice(self.CITY)

        if family == "award":
            prize = rng.choice(self.PRIZE)
            question = f"What prize did the mentor of {a} receive?"
            answer = prize
            doc1 = [f"{a} was a {rng.choice(self.PROFESSION)} of some renown.",
                    f"{a} trained under {b} for many years."]
            doc2 = [f"{b} received the {prize} in {rng.randrange(1900, 1980)}.",
                    f"{b} taught a generation of students."]
            sf = [[a, 1], [b, 0]]
        elif family == "employer":
            company = rng.choice(self.COMPANY)
            question = f"Which company employed the sibling of {a}?"
            answer = company
            doc1 = [f"{a} grew up alongside a sibling, {b}.",
                    f"{a} later settled in {city}."]
            doc2 = [f"{b} worked for {company} for over a decade.",
                    f"{b} retired to the countryside."]
            sf = [[a, 0], [b, 0]]
        else:  # river: the bridge entity is a TOWN document, not a person
            river = rng.choice(self.RIVER)
            # unique town name per sample: a shared CITY title across
            # samples would (title, sid)-collide with a different river
            self._name_counter += 1
            town = f"Port {self._synth_surname(self._name_counter)}"
            question = f"On which river does the hometown of {a} stand?"
            answer = river
            doc1 = [f"{a} was raised in the town of {town}.",
                    f"{a} wrote fondly about those early years."]
            doc2 = [f"{town} stands on the river {river}.",
                    f"{town} grew around a crossing point."]
            sf = [[a, 0], [town, 0]]

        bridge_title = sf[1][0]
        context = [[a, doc1], [bridge_title, doc2]]
        for dnum in range(self.n_distractors):
            drng = random.Random(f"{self.seed}:{i}:hd{dnum}")
            p = self._person(drng)
            if dnum == 0:
                # twin distractor: question person's first name, other surname
                p = f"{a.split()[0]} {p.split(' ', 1)[1]}"
            sents = [f"{p} was a {drng.choice(self.PROFESSION)}."]
            if family == "award":
                sents.append(f"{p} received the {drng.choice(self.PRIZE)} "
                             f"in {drng.randrange(1900, 1980)}.")
            elif family == "employer":
                sents.append(f"{p} worked for {drng.choice(self.COMPANY)} "
                             "briefly.")
            else:
                c2 = drng.choice(self.CITY)
                sents.append(f"{p} settled near {c2} on the river "
                             f"{drng.choice(self.RIVER)}.")
            context.append([p, sents])
        rng.shuffle(context)

        sample_id = hashlib.sha1(f"{self.seed}:{i}:h".encode()).hexdigest()[:24]
        return {
            "_id": sample_id,
            "question": question,
            "answer": answer,
            "type": "bridge",
            "level": "medium",
            "context": context,
            "supporting_facts": sf,
        }

    def load(self) -> List[Dict[str, Any]]:
        if self.cfg.get("heldout"):
            make = self._make_sample_heldout
        elif self.variety:
            make = self._make_sample_variety
        else:
            make = self._make_sample
        return [make(i) for i in range(self.index, self.index + self.n)]


DATASET_REGISTRY = {
    "hotpotqa": HotpotQALoader,
    "synthetic_hotpotqa": SyntheticHotpotQALoader,
}


def build_dataset_loader(cfg: Dict[str, Any]) -> DatasetLoader:
    ds_type = cfg.get("type")
    if ds_type not in DATASET_REGISTRY:
        raise ValueError(f"Unknown dataset type: {ds_type!r} (known: {sorted(DATASET_REGISTRY)})")
    return DATASET_REGISTRY[ds_type](cfg)
