"""Document parsers (port of ``pathway_tpu/xpacks/llm/parsers.py``).

A parser is a UDF: ``parser(column)`` is the column expression mapping each
document's ``data`` to a list of ``(text, metadata)`` pairs. ``ParseUtf8``
needs nothing; ``PypdfParser``, ``ParseUnstructured``, ``ImageParser`` and
``SlideParser`` import their package (pypdf, unstructured, PIL, pdf2image)
when they parse, and raise the reference's ``ImportError`` without it.
``ImageParser`` and ``SlideParser`` send each image to a vision LLM as an
OpenAI-style ``image_url`` message; ``SlideParser``'s rasterizer is
injectable (``_rasterizer``), so it runs without poppler.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm._utils import import_client


class ParseUtf8(UDF):
    """bytes/str → [(text, {})]."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)

        def parse(contents: Any) -> list:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return [(text, {})]

        self.func = parse


Utf8Parser = ParseUtf8


class PypdfParser(UDF):
    """PDF → one document per page, through pypdf."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs: Any):
        super().__init__(**kwargs)
        self.apply_text_cleanup = apply_text_cleanup

        def parse(contents: bytes) -> list:
            import io

            pypdf = import_client("pypdf", "pypdf is not installed in this environment")
            reader = pypdf.PdfReader(io.BytesIO(contents))
            docs = []
            for page_num, page in enumerate(reader.pages):
                text = page.extract_text() or ""
                if self.apply_text_cleanup:
                    text = " ".join(text.split())
                docs.append((text, {"page": page_num}))
            return docs

        self.func = parse


class ParseUnstructured(UDF):
    """unstructured.io partitioning: one document (``mode="single"``) or one
    per element, with the element's metadata."""

    def __init__(self, mode: str = "single", post_processors: list | None = None,
                 **unstructured_kwargs: Any):
        super().__init__()
        self.mode = mode
        self.post_processors = post_processors or []
        self.kwargs = dict(unstructured_kwargs)

        def parse(contents: Any) -> list:
            import io

            auto = import_client(
                "unstructured.partition.auto",
                "unstructured is not installed; use ParseUtf8 or PypdfParser",
            )
            elements = auto.partition(
                file=io.BytesIO(contents) if isinstance(contents, bytes) else None,
                text=contents if isinstance(contents, str) else None,
                **self.kwargs,
            )
            for el in elements:
                for proc in self.post_processors:
                    el.apply(proc)
            if self.mode == "single":
                return [("\n\n".join(str(el) for el in elements), {})]
            return [(str(el), el.metadata.to_dict() if el.metadata else {}) for el in elements]

        self.func = parse


UnstructuredParser = ParseUnstructured


DEFAULT_IMAGE_PARSE_PROMPT = (
    "Describe the contents of this image precisely, including any visible text, "
    "tables, and figures."
)


def _image_to_b64(img: Any, fmt: str = "PNG") -> str:
    import base64
    import io

    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _vision_describe(llm: Any, prompt: str, b64: str) -> str:
    """One vision-LLM call in the OpenAI ``image_url`` message shape."""
    messages = [
        {
            "role": "user",
            "content": [
                {"type": "text", "text": prompt},
                {
                    "type": "image_url",
                    "image_url": {"url": f"data:image/png;base64,{b64}"},
                },
            ],
        }
    ]
    fn = getattr(llm, "func", None) or llm
    return str(fn(messages))


class ImageParser(UDF):
    """Image bytes → [(description, metadata)] through a vision LLM.

    The image is decoded with PIL, scaled down to
    ``downsize_horizontal_width`` when wider, and sent base64-encoded to
    ``llm`` (a chat UDF, or any callable taking a messages list)."""

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str = DEFAULT_IMAGE_PARSE_PROMPT,
        downsize_horizontal_width: int | None = 1280,
        include_metadata: bool = True,
        **kwargs: Any,
    ):
        super().__init__()
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.downsize_horizontal_width = downsize_horizontal_width
        self.include_metadata = include_metadata

        def parse(contents: bytes) -> list:
            if self.llm is None:
                raise ValueError(
                    "ImageParser needs a vision-capable `llm` (a chat UDF or any "
                    "callable accepting an OpenAI-style messages list)"
                )
            import io

            pil_image = import_client("PIL.Image")
            img = pil_image.open(io.BytesIO(contents))
            img.load()
            width, height = img.size
            target = self.downsize_horizontal_width
            if target and width > target:
                # the vision-token budget
                img = img.resize((target, max(1, int(height * (target / width)))))
            if img.mode not in ("RGB", "L"):
                img = img.convert("RGB")
            text = _vision_describe(self.llm, self.parse_prompt, _image_to_b64(img))
            meta = (
                {"width": width, "height": height, "format": "png"}
                if self.include_metadata
                else {}
            )
            return [(text, meta)]

        self.func = parse


def _default_rasterizer(contents: bytes) -> list:
    """PDF or slide bytes → one PIL image per slide or page (pdf2image)."""
    pdf2image = import_client(
        "pdf2image",
        "SlideParser needs a slide rasterizer: install pdf2image (poppler) or "
        "pass _rasterizer=... (bytes -> list of PIL images)",
    )
    return pdf2image.convert_from_bytes(contents)


class SlideParser(UDF):
    """Slide-deck bytes → one vision-parsed document per slide, with
    ``slide`` (its number) and ``slide_count`` in the metadata.

    Each slide is rasterized (``_rasterizer``: bytes → a list of images
    with ``size``, ``resize`` and ``save``; pdf2image by default) and goes
    through ``ImageParser``'s vision-LLM path."""

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str = DEFAULT_IMAGE_PARSE_PROMPT,
        downsize_horizontal_width: int | None = 1280,
        _rasterizer: Callable[[bytes], list] | None = None,
        **kwargs: Any,
    ):
        super().__init__()
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.downsize_horizontal_width = downsize_horizontal_width
        self.rasterizer = _rasterizer or _default_rasterizer

        def parse(contents: bytes) -> list:
            if self.llm is None:
                raise ValueError(
                    "SlideParser needs a vision-capable `llm` (a chat UDF or any "
                    "callable accepting an OpenAI-style messages list)"
                )
            images = self.rasterizer(contents)
            docs = []
            target = self.downsize_horizontal_width
            for i, img in enumerate(images):
                w, h = img.size
                if target and w > target:
                    img = img.resize((target, max(1, int(h * (target / w)))))
                text = _vision_describe(self.llm, self.parse_prompt, _image_to_b64(img))
                docs.append((text, {"slide": i, "slide_count": len(images)}))
            return docs

        self.func = parse
