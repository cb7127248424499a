"""``paddle.v2.dataset`` (counterpart of ``paddle_tpu/v2/dataset.py``): each
corpus's loaders (cached corpus or synthetic surrogate, never a
download) as a namespace, and ``common``, the cache and shard tools."""

from ..data import datasets as _d


class mnist:
    train = staticmethod(_d.mnist_train)
    test = staticmethod(_d.mnist_test)


class cifar:
    train10 = staticmethod(_d.cifar10_train)
    test10 = staticmethod(_d.cifar10_test)


class imdb:
    word_dict = staticmethod(_d.imdb_word_dict)
    train = staticmethod(_d.imdb_train)
    test = staticmethod(_d.imdb_test)


class imikolov:
    train = staticmethod(_d.imikolov_train)


class uci_housing:
    train = staticmethod(_d.uci_housing_train)
    test = staticmethod(_d.uci_housing_test)


class wmt14:
    train = staticmethod(_d.wmt14_train)
    test = staticmethod(_d.wmt14_test)
    dicts = staticmethod(_d.wmt14_dicts)


class conll05:
    test = staticmethod(_d.conll05_train)
    train = staticmethod(_d.conll05_train)


class criteo:
    train = staticmethod(_d.criteo_ctr_train)


class movielens:
    train = staticmethod(_d.movielens_train)
    test = staticmethod(_d.movielens_test)
    movie_categories = staticmethod(_d.movielens_movie_categories)
    get_movie_title_dict = staticmethod(_d.movielens_get_movie_title_dict)
    max_user_id = staticmethod(_d.movielens_max_user_id)
    max_movie_id = staticmethod(_d.movielens_max_movie_id)
    max_job_id = staticmethod(_d.movielens_max_job_id)
    user_info = staticmethod(_d.movielens_user_info)
    movie_info = staticmethod(_d.movielens_movie_info)


class sentiment:
    train = staticmethod(_d.sentiment_train)
    test = staticmethod(_d.sentiment_test)
    get_word_dict = staticmethod(_d.sentiment_word_dict)


class voc2012:
    train = staticmethod(_d.voc2012_train)
    test = staticmethod(_d.voc2012_test)
    val = staticmethod(_d.voc2012_val)


class flowers:
    train = staticmethod(_d.flowers_train)
    test = staticmethod(_d.flowers_test)
    valid = staticmethod(_d.flowers_valid)


class mq2007:
    train = staticmethod(_d.mq2007_train)
    test = staticmethod(_d.mq2007_test)


class common:
    """``paddle.v2.dataset.common`` — the download cache (read only: the
    port never downloads) and the shard tools."""

    from ..data.download import (  # noqa: F401
        DATA_HOME,
        DownloadError,
        cached_path,
        cluster_files_reader,
        convert,
        download,
        md5file,
        split,
    )
